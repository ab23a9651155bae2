"""Global occupancy-grid assembly from per-submap counting grids.

Replaces ``MasterMap::getOGM`` (``RS/src/ndt_representation/
ndt_master_map.cpp:20-106``): the reference loops over submaps with 4 OpenMP
threads, resampling each submap counting grid into the global grid through an
std::map of increments.  This build does the same math as batched
gather/scatter:

  * 4-sample anti-aliased resampling per submap cell (:22-36,60-63)
  * per-submap, per-target-cell max-|count| increment (:65-67) — computed as
    a signed scatter-max pair
  * sum of increments across submaps (:72-77)
  * smoothstep count -> occupancy mapping (:97-103)

Also provides the submap-local OGM render (``HierarchicalMap::getOGM``,
``ndt_hierarchical_map.cpp:40-66``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry import rotmat


def submap_occupancy(counts):
    """Submap-local OGM (``ndt_hierarchical_map.cpp:59-64``):
    zeta = clamp(2 + 0.1 c, 0, 4); occ = 100 (-2 (z/4)^3 + 3 (z/4)^2)."""
    z = jnp.clip(2.0 + 0.1 * counts.astype(jnp.float32), 0.0, 4.0) / 4.0
    return 100.0 * (-2.0 * z**3 + 3.0 * z**2)


def global_occupancy(counts_sum, unknown_mask=None):
    """Global OGM mapping (``ndt_master_map.cpp:97-103``):
    zeta = clamp(5 + 0.1 c, 0, 10); occ = 100 (-2 (z/10)^3 + 3 (z/10)^2);
    untouched cells are -1 (unknown)."""
    z = jnp.clip(5.0 + 0.1 * counts_sum.astype(jnp.float32), 0.0, 10.0) / 10.0
    occ = 100.0 * (-2.0 * z**3 + 3.0 * z**2)
    if unknown_mask is None:
        unknown_mask = counts_sum == 0
    return jnp.where(unknown_mask, -1.0, occ)


def _submap_increments(counts, origin_rel, sub_res, glob_res, gh, gw):
    """Resample one submap counting grid into global-grid increments.

    counts: (sh, sw) submap counting grid; origin_rel: (3,) pose of the
    submap OGM origin in the global OGM-origin frame.  Returns (gh*gw,)
    increments using the 4-sample max-|count| rule.
    """
    sh, sw = counts.shape
    ys, xs = jnp.meshgrid(jnp.arange(sh), jnp.arange(sw), indexing="ij")
    # submap-local cell positions (cell corner, matching :55-58)
    local = jnp.stack([xs * sub_res, ys * sub_res], axis=-1).reshape(-1, 2)
    R = rotmat(origin_rel[2])
    base = local @ R.T + origin_rel[:2]
    c = counts.reshape(-1).astype(jnp.float32)

    offsets = jnp.asarray(
        [[-0.25, -0.25], [-0.25, 0.25], [0.25, -0.25], [0.25, 0.25]]
    ) * glob_res
    pos_max = jnp.zeros(gh * gw + 1, jnp.float32)
    neg_max = jnp.zeros(gh * gw + 1, jnp.float32)
    for k in range(4):
        # the sample offset is applied in the submap frame (:60-63)
        p = base + offsets[k] @ R.T
        gx = jnp.floor(p[:, 0] / glob_res).astype(jnp.int32)
        gy = jnp.floor(p[:, 1] / glob_res).astype(jnp.int32)
        ok = (gx >= 0) & (gx < gw) & (gy >= 0) & (gy < gh) & (c != 0)
        flat = jnp.where(ok, gy * gw + gx, gh * gw)
        pos_max = pos_max.at[flat].max(jnp.where(ok, c, 0.0))
        neg_max = neg_max.at[flat].max(jnp.where(ok, -c, 0.0))
    inc = jnp.where(pos_max >= neg_max, pos_max, -neg_max)
    return inc[: gh * gw]


def fuse_submaps(submap_counts, submap_origins, sub_res, glob_res,
                 global_origin, gh, gw):
    """Sum resampled increments over all submaps (``:40-79``).

    submap_counts: (NS, sh, sw); submap_origins: (NS, 3) global poses of each
    submap's OGM origin; global_origin: (3,) pose of the global OGM origin.
    """
    from ..geometry import inverse, compose

    rel = compose(
        jnp.broadcast_to(inverse(global_origin), submap_origins.shape),
        submap_origins,
    )

    def one(counts, o):
        return _submap_increments(counts, o, sub_res, glob_res, gh, gw)

    incs = jax.lax.map(lambda args: one(*args), (submap_counts, rel))
    total = jnp.sum(incs, axis=0)
    return total.reshape(gh, gw)
