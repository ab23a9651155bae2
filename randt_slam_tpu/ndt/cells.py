"""Intensity-augmented NDT cells as sufficient statistics.

The reference stores per-cell mean/covariance and updates them with a
recursive pooled-covariance formula (``RS/src/ndt_representation/ndt_cell.cpp:36-114``,
merge operator ``RS/include/ndt_representation/ndt_cell.h:133-142``).  This
build instead keeps every cell in *sufficient-statistic* form

    n   = number of points
    s   = sum of points p_i            (3,)   [x, y, intensity]
    ss  = sum of outer products p p^T  (3, 3)

so that cell creation is a ``segment_sum``, cell merging is an add, and rigid
transforms are closed-form — all batched, mask-friendly and exactly
associative.  Mean/covariance are derived on demand:

    mean = s / n
    cov  = ss / n - mean mean^T        (biased, matching the reference's
                                        single-batch cells, ``ndt_cell.cpp:65``)

Deviations from the reference (documented):
 * The reference's *merge* of two already-formed cells uses (n-1)/(m-1)
   weights with an integer-division cross term (``ndt_cell.h:136``); the
   sufficient-statistic merge is the exact pooled second moment instead.
 * Eigenvalue regularization (``ndt_cell.cpp:102-112``) is applied when the
   covariance is *read*, not baked into the stored state, so repeated
   merges do not compound the regularization.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import rotmat


class CellStats(NamedTuple):
    """Batch of NDT cells in sufficient-statistic form.

    n:  (...,)       point counts (float32; 0 == empty slot)
    s:  (..., 3)     sum of [x, y, intensity]
    ss: (..., 3, 3)  sum of outer products
    """

    n: jax.Array
    s: jax.Array
    ss: jax.Array

    @property
    def batch_shape(self):
        return self.n.shape


def zeros(shape, dtype=jnp.float32) -> CellStats:
    return CellStats(
        n=jnp.zeros(shape, dtype),
        s=jnp.zeros(shape + (3,), dtype),
        ss=jnp.zeros(shape + (3, 3), dtype),
    )


def from_points(points, mask, segment_ids, num_segments,
                polar=None, beam_cov=None) -> CellStats:
    """Accumulate masked points into cells by segment id.

    points: (P, 3) [x, y, intensity]; mask: (P,) bool; segment_ids: (P,) int32.
    Replaces the per-cluster moment loops of ``Cell::updateCell``
    (``ndt_cell.cpp:43-65``) with one segment-sum pass.

    pNDT (``ndt_cell.cpp:68-82``): when ``polar`` (P, 2) [angle, range] and
    ``beam_cov`` (3, 3) are given, each point's sensor-noise covariance
    J(angle, range) beam_cov J^T is accumulated into ``ss``.  Folding it into
    the second moment is exact: the derived covariance becomes
    sample_cov + mean(J Sigma J^T), and rigid transforms / merges of the
    sufficient statistics remain closed-form.
    """
    # All 13 moment channels in one segment reduction
    # (``ops/segment_moments.py``): [w | w·p | (w·ppᵀ + noise)].
    from ..ops import segment_moments

    chans = _moment_channels(points, mask, polar, beam_cov)
    out = segment_moments(chans, segment_ids, num_segments)
    return CellStats(n=out[:, 0], s=out[:, 1:4], ss=out[:, 4:13].reshape(-1, 3, 3))


def from_points_compact(points, mask, segment_ids, num_segments, k,
                        polar=None, beam_cov=None):
    """Fused :func:`from_points` + :func:`compact`: keep the moments of the
    ``k`` most-populated segments (the scan cell budget).  Returns
    (CellStats (k,), segment ids (k,)).  See ``ops/segment_moments.py``."""
    from ..ops.segment_moments import segment_topk_moments

    chans = _moment_channels(points, mask, polar, beam_cov)
    out, topi = segment_topk_moments(chans, segment_ids, num_segments, k)
    return (
        CellStats(n=out[:, 0], s=out[:, 1:4], ss=out[:, 4:13].reshape(-1, 3, 3)),
        topi,
    )


def _moment_channels(points, mask, polar=None, beam_cov=None):
    """Per-point 13-channel moment vector [w | w·p | (w·ppᵀ + w·noise)]."""
    w = mask.astype(points.dtype)
    pts = points * w[:, None]
    outer = pts[:, :, None] * points[:, None, :]
    if polar is not None:
        a, r = polar[:, 0], polar[:, 1]
        sa, ca = jnp.sin(a), jnp.cos(a)
        zero = jnp.zeros_like(a)
        one = jnp.ones_like(a)
        J = jnp.stack(
            [
                jnp.stack([-r * sa, ca, zero], axis=-1),
                jnp.stack([r * ca, sa, zero], axis=-1),
                jnp.stack([zero, zero, one], axis=-1),
            ],
            axis=-2,
        )
        pcov = jnp.einsum("pij,jk,plk->pil", J, jnp.asarray(beam_cov, points.dtype), J)
        outer = outer + pcov * w[:, None, None]
    return jnp.concatenate([w[:, None], pts, outer.reshape(-1, 9)], axis=-1)


def merge(a: CellStats, b: CellStats) -> CellStats:
    """Exact pooled merge (replaces ``Cell::operator+=``)."""
    return CellStats(n=a.n + b.n, s=a.s + b.s, ss=a.ss + b.ss)


def mean(c: CellStats):
    n = jnp.maximum(c.n, 1.0)
    return c.s / n[..., None]


def raw_cov(c: CellStats):
    """Biased covariance ss/n - mean mean^T (no regularization)."""
    mu = mean(c)
    n = jnp.maximum(c.n, 1.0)
    return c.ss / n[..., None, None] - mu[..., :, None] * mu[..., None, :]


def regularize_cov(cov, eig_floor_ratio=0.001, intensity_jitter=1e-6):
    """Eigenvalue-floor regularization of the 2x2 position block.

    Mirrors ``ndt_cell.cpp:102-112``: lambda_min >= ratio * lambda_max on the
    position block, plus additive jitter on the intensity variance — using
    the closed-form symmetric 2x2 eigendecomposition (batched, no LAPACK).
    """
    a = cov[..., 0, 0]
    b = cov[..., 0, 1]
    d = cov[..., 1, 1]
    tr = a + d
    diff = a - d
    root = jnp.sqrt(jnp.maximum(diff * diff + 4.0 * b * b, 0.0))
    lam_hi = 0.5 * (tr + root)
    lam_lo = 0.5 * (tr - root)
    lam_lo_reg = jnp.maximum(lam_lo, eig_floor_ratio * lam_hi)

    # Eigenvector for lam_hi: v = [b, lam_hi - a] (or [lam_hi - d, b]).
    v1 = jnp.stack([b, lam_hi - a], axis=-1)
    v2 = jnp.stack([lam_hi - d, b], axis=-1)
    use_v2 = jnp.sum(v1 * v1, axis=-1, keepdims=True) < jnp.sum(
        v2 * v2, axis=-1, keepdims=True
    )
    v = jnp.where(use_v2, v2, v1)
    nrm = jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), 1e-30))
    # Degenerate (isotropic) case: any unit vector works.
    iso = nrm[..., 0] < 1e-15
    v = jnp.where(iso[..., None], jnp.array([1.0, 0.0], dtype=cov.dtype), v / nrm)
    vx, vy = v[..., 0], v[..., 1]

    # Reassemble: lam_hi * v v^T + lam_lo_reg * v_perp v_perp^T.
    p00 = lam_hi * vx * vx + lam_lo_reg * vy * vy
    p01 = (lam_hi - lam_lo_reg) * vx * vy
    p11 = lam_hi * vy * vy + lam_lo_reg * vx * vx

    out = cov
    # The tiny absolute position jitter (1e-6 m^2) keeps 3x3 solves finite in
    # float32 for degenerate (empty/near-empty) cells; the reference runs
    # Ceres in double and needs no floor.  Impact on real cells: ~1 mm.
    out = out.at[..., 0, 0].set(p00 + intensity_jitter)
    out = out.at[..., 0, 1].set(p01)
    out = out.at[..., 1, 0].set(p01)
    out = out.at[..., 1, 1].set(p11 + intensity_jitter)
    out = out.at[..., 2, 2].add(intensity_jitter)
    return out


def mean_cov(c: CellStats, eig_floor_ratio=0.001, intensity_jitter=1e-6,
             use_pndt=False):
    """Derived (mean, regularized covariance) pair.

    With pNDT the reference skips the eigenvalue regularization entirely
    (``ndt_cell.cpp:102``); a tiny absolute diagonal jitter is still applied
    for float32 solve stability (documented deviation)."""
    mu = mean(c)
    cov = raw_cov(c)
    if use_pndt:
        jit3 = jnp.asarray(
            [intensity_jitter, intensity_jitter, intensity_jitter], cov.dtype
        )
        return mu, cov + jnp.diag(jit3)
    return mu, regularize_cov(cov, eig_floor_ratio, intensity_jitter)


def valid_mask(c: CellStats, min_points_per_cell: int):
    """Occupancy: a distribution exists iff n > min_points_per_cell
    (strict, matching ``Cell::updateCell``'s guard, ``ndt_cell.cpp:37``)."""
    return c.n > float(min_points_per_cell)


def transform(c: CellStats, pose) -> CellStats:
    """Rigid SE(2) transform of cells (intensity untouched).

    Equivalent to ``Cell::transformCell`` (``ndt_cell.cpp:117-136``) but on
    sufficient statistics: with A = [[R, 0], [0, 1]], t3 = [tx, ty, 0]:
        s'  = A s + n t3
        ss' = A ss A^T + A s t3^T + t3 s^T A^T + n t3 t3^T
    Broadcasts pose (..., 3) over the cell batch (..., C).
    """
    R = rotmat(pose[..., 2])
    dt = c.s.dtype
    zeros2 = jnp.zeros(pose.shape[:-1] + (2, 1), dt)
    a_top = jnp.concatenate([R, zeros2], axis=-1)
    a_bot = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 1.0], dt), pose.shape[:-1] + (1, 3)
    )
    A = jnp.concatenate([a_top, a_bot], axis=-2)  # (..., 3, 3)
    t3 = jnp.concatenate(
        [pose[..., :2], jnp.zeros(pose.shape[:-1] + (1,), dt)], axis=-1
    )  # (..., 3)
    # Broadcast transform over the trailing cell axis of the stats.
    A_ = A[..., None, :, :]
    t_ = t3[..., None, :]
    s_new = jnp.einsum("...ij,...cj->...ci", A, c.s) + c.n[..., None] * t_
    As = jnp.einsum("...ij,...cj->...ci", A, c.s)
    ss_new = (
        jnp.einsum("...ij,...cjk,...lk->...cil", A, c.ss, A)
        + As[..., :, None] * t_[..., None, :]
        + t_[..., :, None] * As[..., None, :]
        + c.n[..., None, None] * (t_[..., :, None] * t_[..., None, :])
    )
    return CellStats(n=c.n, s=s_new, ss=ss_new)


def compact(c: CellStats, k: int):
    """Keep the k most-populated cells (stable order by count).

    Used to turn dense cluster/grid slot arrays into fixed small batches for
    matching and storage.  Returns (CellStats with batch (k,), order_idx).
    """
    n = c.n
    _, idx = jax.lax.top_k(n, k)
    return CellStats(n=c.n[idx], s=c.s[idx], ss=c.ss[idx]), idx


def mahalanobis_sq_position(mu_a, cov_a, mu_b, cov_b):
    """2-D position-block L2 distance between two distributions
    (``Cell::mahalanobisSquared``, ``ndt_cell.cpp:165-170``).  Defined but
    never called by the reference's default paths (its non-intensity NN
    lookup is Euclidean, ``ndt_map.cpp:101-126``); provided for parity.
    Accepts 3-D cell fields and slices the position blocks."""
    dx = mu_b[..., 0] - mu_a[..., 0]
    dy = mu_b[..., 1] - mu_a[..., 1]
    s00 = cov_a[..., 0, 0] + cov_b[..., 0, 0]
    s01 = cov_a[..., 0, 1] + cov_b[..., 0, 1]
    s11 = cov_a[..., 1, 1] + cov_b[..., 1, 1]
    det = s00 * s11 - s01 * s01
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    return (s11 * dx * dx - 2.0 * s01 * dx * dy + s00 * dy * dy) / det


def mahalanobis_sq_intensity(mu_a, cov_a, mu_b, cov_b):
    """L2 distance between two 3-D distributions:
    (mu_b - mu_a)^T (cov_a + cov_b)^{-1} (mu_b - mu_a)
    (``Cell::mahalanobisSquaredIntensity``, ``ndt_cell.cpp:172-176``).
    Batched over leading axes.
    """
    d = mu_b - mu_a
    S = cov_a + cov_b
    sol = solve3(S, d)
    return jnp.einsum("...i,...i->...", d, sol)


def solve3(S, d):
    """Batched 3x3 symmetric solve via adjugate (no LAPACK; VPU-friendly)."""
    a, b, e = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    c_, f = S[..., 1, 1], S[..., 1, 2]
    g = S[..., 2, 2]
    A = c_ * g - f * f
    B = e * f - b * g
    C = b * f - c_ * e
    det = a * A + b * B + e * C
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    D = a * g - e * e
    E = b * e - a * f
    F = a * c_ - b * b
    x = (A * d[..., 0] + B * d[..., 1] + C * d[..., 2]) / det
    y = (B * d[..., 0] + D * d[..., 1] + E * d[..., 2]) / det
    z = (C * d[..., 0] + E * d[..., 1] + F * d[..., 2]) / det
    return jnp.stack([x, y, z], axis=-1)


def det3(S):
    a, b, e = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    c_, f = S[..., 1, 1], S[..., 1, 2]
    g = S[..., 2, 2]
    return (
        a * (c_ * g - f * f) + b * (e * f - b * g) + e * (b * f - c_ * e)
    )


def inv3(S):
    """Batched symmetric 3x3 inverse via adjugate."""
    a, b, e = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    c_, f = S[..., 1, 1], S[..., 1, 2]
    g = S[..., 2, 2]
    A = c_ * g - f * f
    B = e * f - b * g
    C = b * f - c_ * e
    det = a * A + b * B + e * C
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    D = a * g - e * e
    E = b * e - a * f
    F = a * c_ - b * b
    row0 = jnp.stack([A, B, C], axis=-1)
    row1 = jnp.stack([B, D, E], axis=-1)
    row2 = jnp.stack([C, E, F], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) / det[..., None, None]
