"""2-D pose-graph optimization as batched Gauss-Newton on device.

Replaces ``GlobalFuser::optimizePoseGraph`` (``RS/src/global_fuser/
global_fuser.cpp:13-105``), which hands a dynamically-built problem to Ceres'
sparse Cholesky.  This build assembles the normal equations from all edges
at once — per-edge 3x3 Jacobian blocks are closed-form — scatter-adds them
into a dense (3N, 3N) system, and solves it with a damped Cholesky.
Radar pose graphs are small (O(10^3) nodes, so 3N <= ~2*10^4: a dense solve is
a few ms on one chip); a Schur-complement/distributed path for larger graphs
lives in ``graph/schur.py``.

Residual (``pose_graph_2d_error_term.h:63-105``):
    r = sqrtI @ [ R_a^T (p_b - p_a) - t_ab ; Normalize(yaw_b - yaw_a - yaw_ab) ]

Edge selection matches ``global_fuser.cpp:30-47``: consecutive edges always,
loop edges only while ``id_end <= max_update_index``.  The first pose is
gauge-fixed (:48-49).  Optional Huber loss (:17-23) applied as IRLS weights.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import GlobalFuserConfig
from ..geometry import normalize_angle


class PoseGraph(NamedTuple):
    """Fixed-shape edge list (padded; ``valid`` masks)."""

    poses: jax.Array       # (N, 3) initial node poses
    id_begin: jax.Array    # (E,) int32
    id_end: jax.Array      # (E,) int32
    trans: jax.Array       # (E, 3) measured relative SE(2)
    sqrt_information: jax.Array  # (E, 3, 3)
    valid: jax.Array       # (E,) bool


def edge_residuals(poses, g: PoseGraph):
    """(E, 3) whitened residuals."""
    pa = poses[g.id_begin]
    pb = poses[g.id_end]
    ca, sa = jnp.cos(pa[:, 2]), jnp.sin(pa[:, 2])
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    ex = ca * dx + sa * dy - g.trans[:, 0]
    ey = -sa * dx + ca * dy - g.trans[:, 1]
    eth = normalize_angle(pb[:, 2] - pa[:, 2] - g.trans[:, 2])
    e = jnp.stack([ex, ey, eth], axis=-1)
    return jnp.einsum("eij,ej->ei", g.sqrt_information, e)


def _edge_jacobians(poses, g: PoseGraph):
    """Closed-form (E, 3, 3) Jacobian blocks w.r.t. pose_a and pose_b."""
    pa = poses[g.id_begin]
    pb = poses[g.id_end]
    ca, sa = jnp.cos(pa[:, 2]), jnp.sin(pa[:, 2])
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    zero = jnp.zeros_like(ca)
    one = jnp.ones_like(ca)
    # d e / d pose_a : [[-c, -s, -s*dx + c*dy], [s, -c, -c*dx - s*dy], [0,0,-1]]
    Ja = jnp.stack(
        [
            jnp.stack([-ca, -sa, -sa * dx + ca * dy], axis=-1),
            jnp.stack([sa, -ca, -ca * dx - sa * dy], axis=-1),
            jnp.stack([zero, zero, -one], axis=-1),
        ],
        axis=-2,
    )
    Jb = jnp.stack(
        [
            jnp.stack([ca, sa, zero], axis=-1),
            jnp.stack([-sa, ca, zero], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    Ja = jnp.einsum("eij,ejk->eik", g.sqrt_information, Ja)
    Jb = jnp.einsum("eij,ejk->eik", g.sqrt_information, Jb)
    return Ja, Jb


def spd_solve(H, b):
    """Solve the damped gauge-fixed normal equations via Cholesky.

    The system is SPD by construction (Gauss-Newton H + positive LM damping,
    identity rows on gauge-fixed DOFs), so Cholesky is the right
    factorization.
    """
    c = jax.scipy.linalg.cho_factor(H, lower=True)
    return jax.scipy.linalg.cho_solve(c, b)


def _huber_weight(r, scale):
    """IRLS weight of Ceres' HuberLoss on squared norm s = ||r||^2."""
    s = jnp.sum(r * r, axis=-1)
    b = scale * scale
    return jnp.where(s <= b, 1.0, jnp.sqrt(b / jnp.maximum(s, 1e-30)))


def _dcs_weight(r, scale):
    """IRLS weight of Dynamic Covariance Scaling (Agarwal et al., ICRA'13):
    w = min(1, (2*phi / (phi + s))^2), s = ||r||^2, phi = scale^2.  Unlike
    Huber's 1/||r|| tail this redescends, driving gross outliers to ~zero."""
    s = jnp.sum(r * r, axis=-1)
    phi = scale * scale
    return jnp.minimum(1.0, (2.0 * phi / (phi + s)) ** 2)


def robust_spec(cfg: GlobalFuserConfig):
    """Hashable robust-loss spec — ``None`` when off, else
    ``(kernel, loop_edges_only)``.  Used both to compute IRLS weights and as
    part of the Schur kernel-cache key.

    The shipped DCS loop defense (``cfg.dcs_loop_defense``) is
    NOT reflected here: applying a redescending kernel from a drifted init
    suppresses genuine loop edges (their residuals are large until PGO
    corrects the drift), so the defense only activates in stage 2 of
    :func:`schur.optimize_auto`'s two-stage schedule, which rewrites the
    stage-2 config to a ``("dcs", loop-only)`` spec at ``dcs_scale``."""
    if not cfg.use_robust_loss:
        return None
    return (cfg.robust_kernel, bool(cfg.robust_loop_edges_only))


def robust_two_stage(cfg: GlobalFuserConfig) -> bool:
    """Whether the PGO should run the two-stage schedule: always for the DCS
    defense (part of its design — see ``GlobalFuserConfig.dcs_loop_defense``),
    opt-in for the reference-parity robust knob."""
    if cfg.dcs_loop_defense:
        return True
    return bool(cfg.use_robust_loss and cfg.robust_two_stage)


def robust_weight(r, id_begin, id_end, scale, spec):
    """Per-edge IRLS weight for a robust spec (``spec`` is static)."""
    kernel, loop_only = spec
    if kernel == "dcs":
        w = _dcs_weight(r, scale)
    elif kernel == "huber":
        w = _huber_weight(r, scale)
    else:
        raise ValueError(f"unknown robust kernel {kernel!r}")
    if loop_only:
        w = jnp.where(id_begin + 1 != id_end, w, 1.0)
    return w


def _assemble(poses, g: PoseGraph, robust, huber_scale: float):
    N = poses.shape[0]
    r = edge_residuals(poses, g)
    Ja, Jb = _edge_jacobians(poses, g)
    w = g.valid.astype(poses.dtype)
    if robust is not None:
        w = w * robust_weight(r, g.id_begin, g.id_end, huber_scale, robust)
    Wa = Ja * w[:, None, None]
    Wb = Jb * w[:, None, None]

    Haa = jnp.einsum("eij,eik->ejk", Wa, Ja)
    Hab = jnp.einsum("eij,eik->ejk", Wa, Jb)
    Hbb = jnp.einsum("eij,eik->ejk", Wb, Jb)
    ga = jnp.einsum("eij,ei->ej", Wa, r)
    gb = jnp.einsum("eij,ei->ej", Wb, r)

    H = jnp.zeros((N, 3, N, 3), poses.dtype)
    ia = g.id_begin
    ib = g.id_end
    H = H.at[ia, :, ia, :].add(Haa)
    H = H.at[ia, :, ib, :].add(Hab)
    H = H.at[ib, :, ia, :].add(jnp.swapaxes(Hab, -1, -2))
    H = H.at[ib, :, ib, :].add(Hbb)
    grad = jnp.zeros((N, 3), poses.dtype)
    grad = grad.at[ia].add(ga)
    grad = grad.at[ib].add(gb)

    cost = 0.5 * jnp.sum(w * jnp.sum(r * r, axis=-1))
    return H.reshape(3 * N, 3 * N), grad.reshape(3 * N), cost


def optimize(
    g: PoseGraph,
    cfg: GlobalFuserConfig,
    max_update_index=None,
    fixed_mask=None,
):
    """Gauss-Newton with LM damping over the whole graph.

    max_update_index: loop edges with id_end above it are excluded (odometry
    edges always kept, ``global_fuser.cpp:31``).  fixed_mask (N,) bool marks
    gauge-fixed nodes (default: node 0 only).
    Returns (poses, diagnostics dict of final cost / iterations).
    """
    N = g.poses.shape[0]
    dtype = g.poses.dtype
    if fixed_mask is None:
        fixed_mask = jnp.zeros(N, bool).at[0].set(True)
    if max_update_index is not None:
        consecutive = g.id_begin + 1 == g.id_end
        keep = consecutive | (g.id_end <= max_update_index)
        g = g._replace(valid=g.valid & keep)

    free = ~jnp.repeat(fixed_mask, 3)
    free_f = free.astype(dtype)
    robust = robust_spec(cfg)

    def body(carry):
        poses, lam, cost_prev, it, done = carry
        H, grad, cost = _assemble(
            poses, g._replace(poses=poses), robust,
            cfg.loss_function_scale,
        )
        H = H * free_f[:, None] * free_f[None, :]
        grad = grad * free_f
        diag = jnp.diag(H)
        damp = lam * jnp.maximum(diag, 1e-8) + (1.0 - free_f)
        delta = -spd_solve(H + jnp.diag(damp), grad) * free_f
        trial = poses + delta.reshape(N, 3)
        trial = trial.at[:, 2].set(normalize_angle(trial[:, 2]))
        _, _, cost_new = _assemble(
            trial, g._replace(poses=trial), robust,
            cfg.loss_function_scale,
        )
        accept = cost_new < cost
        poses_n = jnp.where(accept, trial, poses)
        lam_n = jnp.clip(jnp.where(accept, lam / 3.0, lam * 4.0), 1e-12, 1e8)
        small = jnp.linalg.norm(delta) < cfg.tolerance * (1.0 + jnp.linalg.norm(poses))
        done_n = (accept & small) | ((~accept) & (lam >= 1e7))
        return poses_n, lam_n, jnp.where(accept, cost_new, cost), it + 1, done_n

    def cond(carry):
        _, _, _, it, done = carry
        return (it < cfg.max_iterations) & (~done)

    poses0 = g.poses
    init = (poses0, jnp.asarray(1e-6, dtype), jnp.asarray(jnp.inf, dtype),
            jnp.int32(0), jnp.bool_(False))
    poses, _, cost, iters, _ = jax.lax.while_loop(cond, body, init)
    return poses, {"cost": cost, "iterations": iters}


_BUCKET_CACHE: dict = {}


def _bucket(n: int, q: int) -> int:
    return int(-(-max(n, 1) // q) * q)


def optimize_bucketed(g: PoseGraph, cfg: GlobalFuserConfig,
                      max_update_index=None,
                      bucket_nodes: int = 256, bucket_edges: int = 512):
    """Shape-bucketed, jit-cached wrapper of :func:`optimize`.

    Online PGO runs on a graph that GROWS every tick; calling
    :func:`optimize` directly re-traces (and on a cold XLA cache re-compiles)
    per tick because every tick has a new (N, E) shape.  Padding nodes and
    edges up to bucket multiples gives successive ticks the same compiled
    executable — the dense-path analogue of the Schur kernel bucketing
.  Padded nodes are gauge-fixed and padded edges
    invalid, so the solution is bit-identical to the unpadded solve.
    """
    import numpy as np

    # Padding and edge filtering happen HOST-SIDE in numpy: with jnp inputs
    # every tick's new (N, E) shape would lower ~10 fresh eager concatenate /
    # compare kernels — a compile each per ONLINE PGO TICK.  The jitted solve
    # uploads the padded graph.
    g = jax.tree.map(np.asarray, g)
    N = g.poses.shape[0]
    E = g.id_begin.shape[0]
    if max_update_index is not None:
        consecutive = g.id_begin + 1 == g.id_end
        keep = consecutive | (g.id_end <= max_update_index)
        g = g._replace(valid=g.valid & keep)
    N_pad = _bucket(N, bucket_nodes)
    E_pad = _bucket(E, bucket_edges)
    dtype = g.poses.dtype
    if N_pad != N or E_pad != E:
        pe = E_pad - E
        g = PoseGraph(
            poses=np.concatenate(
                [g.poses, np.zeros((N_pad - N, 3), dtype)]),
            id_begin=np.concatenate(
                [g.id_begin, np.zeros(pe, g.id_begin.dtype)]),
            id_end=np.concatenate([g.id_end, np.zeros(pe, g.id_end.dtype)]),
            trans=np.concatenate([g.trans, np.zeros((pe, 3), dtype)]),
            sqrt_information=np.concatenate(
                [g.sqrt_information, np.zeros((pe, 3, 3), dtype)]),
            valid=np.concatenate([g.valid, np.zeros(pe, bool)]),
        )
    fixed = np.zeros(N_pad, bool)
    fixed[0] = True
    fixed[N:] = True
    key = (N_pad, E_pad, cfg)
    fn = _BUCKET_CACHE.get(key)
    if fn is None:
        fn = jax.jit(lambda g_, fm: optimize(g_, cfg, fixed_mask=fm))
        _BUCKET_CACHE[key] = fn
    poses, info = fn(g, jnp.asarray(fixed))
    return poses[:N], info


def recover_covariances(g: PoseGraph, poses, cfg: GlobalFuserConfig,
                        fixed_mask=None):
    """Marginal per-node covariance recovery — the capability that is present
    but commented out in the reference (``global_fuser.cpp:62-87``,
    ``ceres::Covariance`` over (pos, rot) blocks).

    Returns (N, 3, 3) diagonal blocks of H^-1 at the solution; gauge-fixed
    nodes get zeros (they are exact by definition).  Dense inverse: radar
    pose graphs are O(10^3) nodes, so (3N)^2 stays small.
    """
    N = poses.shape[0]
    dtype = poses.dtype
    if fixed_mask is None:
        fixed_mask = jnp.zeros(N, bool).at[0].set(True)
    H, _, _ = _assemble(
        poses, g._replace(poses=poses), robust_spec(cfg),
        cfg.loss_function_scale,
    )
    free = (~jnp.repeat(fixed_mask, 3)).astype(dtype)
    # gauge-fix: identity rows/cols on fixed params, small ridge elsewhere
    Hf = H * free[:, None] * free[None, :] + jnp.diag(1.0 - free + 1e-9)
    cov = spd_solve(Hf, jnp.eye(Hf.shape[0], dtype=dtype))
    blocks = cov.reshape(N, 3, N, 3)
    diag = jnp.einsum("iaib->iab", blocks)
    return diag * free.reshape(N, 3)[:, :, None] * free.reshape(N, 3)[:, None, :]
