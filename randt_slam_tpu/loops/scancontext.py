"""ScanContext loop-closure descriptors, fully vectorized.

Re-architecture of the vendored ScanContext implementation
(``RS/src/local_fuser/Scancontext/Scancontext.cpp``) with RaNDT's radar
modifications: bins ACCUMULATE intensity * intensity_factor instead of taking
max height (``makeScancontext``, :156-203), and candidate scoring adds an
odometry-consistency penalty (``distanceBtnScanContext``, :146-151).

Batched mapping:
  * descriptor build      -> 2-D histogram scatter-add over (ring, sector)
  * ring-key kNN          -> one (Q, N) distance matmul + causal mask + top-k
    (replaces the incrementally rebuilt nanoflann kd-tree, :275-301)
  * shift alignment       -> all-shift column-cosine tensor contraction
    (replaces ``circshift`` loops, :93-145)

Reference quirk reproduced on purpose: ``makeScancontext`` initializes bins at
NO_POINT = -1000 and then ADDS z, resetting only bins that remain exactly
-1000; occupied bins therefore carry (sum_z - 1000), making the descriptor
occupancy-dominated.  The shipped ``dist_thresh`` is tuned against this
behavior, so we replicate it (flag ``legacy_no_point_offset``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import ScanContextConfig

NO_POINT = -1000.0


def make_descriptor(polar, intensity, mask, cfg: ScanContextConfig,
                    legacy_no_point_offset: bool = True):
    """Build one (num_ring, num_sector) descriptor from sensor-frame returns.

    polar: (P, 2) [angle rad, range m]; intensity: (P,); mask: (P,) bool.
    Matches ``makeScancontext`` bin arithmetic: ring/sector from
    ceil(frac * n) clamped to [1, n] (:184-185), additive z accumulation with
    the NO_POINT offset quirk (:164,190-198).
    """
    Rn, Sn = cfg.num_ring, cfg.num_sector
    ang = polar[..., 0]
    rng = polar[..., 1]
    z = intensity * cfg.intensity_factor

    keep = mask & (rng <= cfg.max_radius)
    ring = jnp.clip(
        jnp.ceil(rng / cfg.max_radius * Rn).astype(jnp.int32), 1, Rn
    ) - 1
    az_deg = jnp.rad2deg(ang) % 360.0
    sector = jnp.clip(
        jnp.ceil(az_deg / 360.0 * Sn).astype(jnp.int32), 1, Sn
    ) - 1
    flat = jnp.where(keep, ring * Sn + sector, Rn * Sn)

    sums = jax.ops.segment_sum(
        jnp.where(keep, z, 0.0), flat, num_segments=Rn * Sn + 1
    )[: Rn * Sn]
    counts = jax.ops.segment_sum(
        keep.astype(jnp.float32), flat, num_segments=Rn * Sn + 1
    )[: Rn * Sn]
    occupied = counts > 0
    if legacy_no_point_offset:
        desc = jnp.where(occupied, sums + NO_POINT, 0.0)
    else:
        desc = jnp.where(occupied, sums, 0.0)
    return desc.reshape(Rn, Sn)


def ring_key(desc):
    """Row-wise mean (``makeRingkeyFromScancontext``, :206-219)."""
    return jnp.mean(desc, axis=-1)


def sector_key(desc):
    """Column-wise mean (``makeSectorkeyFromScancontext``, :222-235)."""
    return jnp.mean(desc, axis=-2)


def _all_shift_cosine_dist(d1, d2):
    """distDirectSC at every column shift of d2 (``:69-90`` + ``circshift``).

    d1, d2: (R, S).  Returns (S,) distances where entry s uses d2 shifted so
    that column j of d1 is compared against column (j - s) mod S of d2
    (circshift moves columns RIGHT by s).
    """
    R, S = d1.shape
    cols = jnp.arange(S)
    idx = (cols[None, :] - cols[:, None]) % S  # (S, S): [s, j] -> source col
    # All column-pair dot products as ONE (S, S) matmul, then a
    # tiny gather per shift — materializing the rolled descriptor per shift
    # ((R, S, S) per candidate) OOMed at Oxford-length loop batches.
    M = jnp.einsum("rj,rk->jk", d1, d2)        # M[j, k] = d1[:, j] . d2[:, k]
    dots = M[cols[None, :], idx]               # (S_shift, S_col)
    n1 = jnp.linalg.norm(d1, axis=0)  # (S,)
    col2 = jnp.linalg.norm(d2, axis=0)  # (S,)
    n2 = col2[idx]  # (S_shift, S)
    valid = (n1[None, :] > 0) & (n2 > 0)
    cos = jnp.where(valid, dots / jnp.maximum(n1[None, :] * n2, 1e-20), 0.0)
    n_eff = jnp.maximum(jnp.sum(valid, axis=1), 1)
    sim = jnp.sum(cos, axis=1) / n_eff
    return 1.0 - sim  # (S,)


def _sector_key_align(vk1, vk2):
    """fastAlignUsingVkey (:93-113): argmin over shifts of ||vk1 - roll(vk2)||."""
    S = vk1.shape[0]
    cols = jnp.arange(S)
    idx = (cols[None, :] - cols[:, None]) % S
    shifted = vk2[idx]  # (S_shift, S)
    diff = vk1[None, :] - shifted
    return jnp.argmin(jnp.sum(diff * diff, axis=1))


def pair_distance(d1, d2, pos1, pos2, dist1, dist2, cfg: ScanContextConfig):
    """distanceBtnScanContext (:116-153): shift-searched cosine distance plus
    the odometry-drift penalty.  Returns (distance, argmin shift)."""
    S = cfg.num_sector
    vk1, vk2 = sector_key(d1), sector_key(d2)
    center = _sector_key_align(vk1, vk2)
    radius = int(round(0.5 * cfg.search_ratio * S))
    offs = jnp.arange(S)
    ring_dist = jnp.minimum((offs - center) % S, (center - offs) % S)
    allowed = ring_dist <= radius

    dists = _all_shift_cosine_dist(d1, d2)
    dists = jnp.where(allowed, dists, jnp.inf)
    best_shift = jnp.argmin(dists)
    min_dist = dists[best_shift]

    t_err = jnp.maximum(jnp.linalg.norm(pos2 - pos1) - cfg.odom_eps, 0.0) / (
        dist2 - dist1
    )
    odom_dist = 1.0 - jnp.exp(-(t_err * t_err) / (2.0 * cfg.assumed_drift**2))
    total = min_dist + odom_dist * cfg.num_ring * cfg.odom_weight
    return total, best_shift


class LoopCandidate(NamedTuple):
    match_id: jax.Array   # () int32, -1 if none
    yaw_rad: jax.Array    # () aligned yaw offset
    distance: jax.Array   # () combined distance


def detect(
    query_idx,
    descriptors,    # (N, R, S) all keyframe descriptors
    ring_keys,      # (N, R)
    positions,      # (N, 2) odometry positions
    distances,      # (N,) traversed distances
    n_valid,        # () int32 number of valid keyframes
    cfg: ScanContextConfig,
) -> LoopCandidate:
    """detectLoopClosureID (:256-341) for one query against the database.

    Candidates: ring-key kNN among ids <= query - NUM_EXCLUDE_RECENT (the
    reference's tree cutoff, :280), then shift-aligned scoring; accepted if
    the best combined distance < dist_thresh (:330-333).
    """
    N = ring_keys.shape[0]
    q_key = ring_keys[query_idx]
    d2 = jnp.sum((ring_keys - q_key[None, :]) ** 2, axis=1)
    ids = jnp.arange(N)
    eligible = (ids <= query_idx - cfg.num_exclude_recent) & (ids < n_valid)
    d2 = jnp.where(eligible, d2, jnp.inf)
    k = min(cfg.num_candidates, N)  # database may be shorter than the kNN k
    neg, cand = jax.lax.top_k(-d2, k)
    cand_ok = jnp.isfinite(neg)

    q_desc = descriptors[query_idx]
    q_pos = positions[query_idx]
    q_dist = distances[query_idx]

    def score(ci):
        return pair_distance(
            q_desc, descriptors[ci], q_pos, positions[ci],
            q_dist, distances[ci], cfg,
        )

    dists, shifts = jax.vmap(score)(cand)
    dists = jnp.where(cand_ok, dists, jnp.inf)
    best = jnp.argmin(dists)
    min_dist = dists[best]
    accept = min_dist < cfg.dist_threshold
    yaw = shifts[best].astype(jnp.float32) * jnp.deg2rad(
        jnp.float32(cfg.unit_sector_angle_deg)
    )
    return LoopCandidate(
        match_id=jnp.where(accept, cand[best], -1).astype(jnp.int32),
        yaw_rad=yaw,
        distance=min_dist,
    )
