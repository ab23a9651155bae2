"""Dense NDT submap grid: scatter-merge, neighbor lookup, compaction.

The reference ``Map`` (``RS/src/ndt_representation/ndt_map.cpp``) keeps a dense
int index grid pointing into a sparse cell vector and does ring-search nearest
neighbors per query cell (``ndt_map.cpp:101-151``).  This build keeps the
grid itself dense — one :class:`~randt_slam_tpu.ndt.cells.CellStats` batch of
shape (H, W) — so that

 * cluster/keyframe insertion is a scatter-add of sufficient statistics
   (replacing ``Map::mergeMapCell``'s per-cell recursive update,
   ``ndt_map.cpp:191-207``),
 * neighbor lookup is a static window gather + masked top-k
   (replacing the ring search),
 * whole-map rigid transforms re-key cells by their transformed means
   (the reference's ``transformMap`` transforms cell contents but leaves the
   spatial index stale — re-keying is a deliberate fix).

Grid layout: row-major (iy, ix); ix = floor((x - offset_x)/res), matching
``Map::coordinateToIndex`` with offset = -size/2 * res (``ndt_map.cpp:19-20``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import MapConfig
from . import cells as C
from .cells import CellStats


class GridGeom(NamedTuple):
    size_x: int
    size_y: int
    resolution: float

    @property
    def offset_x(self) -> float:
        return -0.5 * self.size_x * self.resolution

    @property
    def offset_y(self) -> float:
        return -0.5 * self.size_y * self.resolution

    @classmethod
    def from_config(cls, m: MapConfig) -> "GridGeom":
        return cls(size_x=m.size_x, size_y=m.size_y, resolution=m.resolution)


def empty_grid(geom: GridGeom, dtype=jnp.float32) -> CellStats:
    return C.zeros((geom.size_y, geom.size_x), dtype)


def cell_index(geom: GridGeom, xy):
    """(ix, iy, in_bounds) for positions (..., 2)."""
    ix = jnp.floor((xy[..., 0] - geom.offset_x) / geom.resolution).astype(jnp.int32)
    iy = jnp.floor((xy[..., 1] - geom.offset_y) / geom.resolution).astype(jnp.int32)
    ok = (ix >= 0) & (ix < geom.size_x) & (iy >= 0) & (iy < geom.size_y)
    return ix, iy, ok


def scatter_cells(geom: GridGeom, grid: CellStats, new: CellStats, valid) -> CellStats:
    """Merge a batch of cells into the grid, keyed by each cell's mean
    (``Map::mergeMapCell``: key = coordinateToIndex(cell mean)).  Colliding
    cells merge by sufficient-statistic addition."""
    mu = C.mean(new)
    ix, iy, ok = cell_index(geom, mu[..., :2])
    ok = ok & valid
    flat = jnp.where(ok, iy * geom.size_x + ix, geom.size_x * geom.size_y)
    H, W = geom.size_y, geom.size_x
    n = grid.n.reshape(-1)
    s = grid.s.reshape(-1, 3)
    ss = grid.ss.reshape(-1, 3, 3)
    w = ok.astype(new.n.dtype)
    n = n.at[flat].add(new.n * w, mode="drop")
    s = s.at[flat].add(new.s * w[..., None], mode="drop")
    ss = ss.at[flat].add(new.ss * w[..., None, None], mode="drop")
    return CellStats(n=n.reshape(H, W), s=s.reshape(H, W, 3), ss=ss.reshape(H, W, 3, 3))


def transform_grid(geom: GridGeom, grid: CellStats, pose, min_points: int) -> CellStats:
    """Rigid-transform a whole grid and re-key cells by transformed means.

    Replaces ``Map::transformMap`` + the submap re-anchoring path.  Cells that
    land outside the grid are dropped (reference would warn out-of-bounds).
    """
    flat = CellStats(
        n=grid.n.reshape(-1), s=grid.s.reshape(-1, 3), ss=grid.ss.reshape(-1, 3, 3)
    )
    moved = C.transform(CellStats(flat.n[None], flat.s[None], flat.ss[None]),
                        pose[None])
    moved = CellStats(moved.n[0], moved.s[0], moved.ss[0])
    out = empty_grid(geom, grid.n.dtype)
    return scatter_cells(geom, out, moved, moved.n > 0)


def compact_grid(geom: GridGeom, grid: CellStats, k: int, min_points: int):
    """Extract the k most-populated cells from a grid as a flat batch.

    Returns (CellStats (k,), valid (k,)).  Used to persist finished submaps
    for the batched loop-closure pass.
    """
    flat = CellStats(
        n=grid.n.reshape(-1), s=grid.s.reshape(-1, 3), ss=grid.ss.reshape(-1, 3, 3)
    )
    picked, idx = C.compact(flat, k)
    return picked, picked.n > float(min_points)


class SparseGrid(NamedTuple):
    """NDT submap as a dense int32 index grid over a compact cell table.

    This mirrors the reference ``Map``'s actual storage — a dense
    ``grid_indizes_`` int grid pointing into a sparse ``grid_`` cell vector
    (``RS/include/ndt_representation/ndt_map.h:155-162``) — rather than the
    fully dense stats grid of this engine's first design.  Only ~2-4k of the 160k
    Oxford grid slots are ever occupied, so keeping sufficient statistics
    densely wasted HBM bandwidth on every carry copy, full-grid derive and
    window gather.  Here:

      index: (H, W) int32, -1 = empty, else slot into the stats table
      stats: CellStats with batch (S,) — compact sufficient statistics
      count: () int32 — allocated slots (monotone per submap lifetime)
    """

    index: jax.Array
    stats: CellStats
    count: jax.Array


def empty_sparse(geom: GridGeom, capacity: int, dtype=jnp.float32) -> SparseGrid:
    return SparseGrid(
        index=jnp.full((geom.size_y, geom.size_x), -1, jnp.int32),
        stats=C.zeros((capacity,), dtype),
        count=jnp.int32(0),
    )


def scatter_sparse(geom: GridGeom, sg: SparseGrid, new: CellStats, valid) -> SparseGrid:
    """Merge a batch of cells into the sparse grid, keyed by cell mean.

    Replaces ``Map::mergeMapCell`` (``ndt_map.cpp:191-207``): existing target
    cells merge by sufficient-statistic addition; new targets allocate table
    slots.  Allocation is batched: first-occurrence winners per target grid
    slot are selected with a scatter-min race, assigned consecutive slots via
    a prefix sum, and written into the index grid; every incoming cell then
    re-gathers its slot so in-batch duplicates merge into the winner's slot.
    Table overflow drops cells (the reference would grow; capacity is sized
    so this never fires in practice).
    """
    S = sg.stats.n.shape[0]
    HW = geom.size_x * geom.size_y
    mu = C.mean(new)
    ix, iy, inb = cell_index(geom, mu[..., :2])
    ok = inb & valid & (new.n > 0)
    flat = jnp.where(ok, iy * geom.size_x + ix, 0)
    idx_flat = sg.index.reshape(-1)

    cur = idx_flat[flat]
    is_new = ok & (cur < 0)
    Cn = flat.shape[0]
    pos = jnp.arange(Cn, dtype=jnp.int32)
    race = jnp.full((HW,), Cn, jnp.int32)
    race = race.at[jnp.where(is_new, flat, HW)].min(pos, mode="drop")
    winner = is_new & (race[flat] == pos)
    order = jnp.cumsum(winner.astype(jnp.int32)) - 1
    slot_w = sg.count + order
    alloc = winner & (slot_w < S)
    idx_flat = idx_flat.at[jnp.where(alloc, flat, HW)].set(
        slot_w.astype(jnp.int32), mode="drop"
    )

    slot = idx_flat[flat]
    use = ok & (slot >= 0)
    tgt = jnp.where(use, slot, S)
    w = use.astype(new.n.dtype)
    stats = CellStats(
        n=sg.stats.n.at[tgt].add(new.n * w, mode="drop"),
        s=sg.stats.s.at[tgt].add(new.s * w[..., None], mode="drop"),
        ss=sg.stats.ss.at[tgt].add(new.ss * w[..., None, None], mode="drop"),
    )
    count = jnp.minimum(sg.count + jnp.sum(winner.astype(jnp.int32)), S)
    return SparseGrid(
        index=idx_flat.reshape(geom.size_y, geom.size_x), stats=stats, count=count
    )


def transform_sparse(geom: GridGeom, sg: SparseGrid, pose) -> SparseGrid:
    """Rigid-transform a sparse grid and re-key cells by transformed means.

    Replaces ``Map::transformMap`` + submap re-anchoring; only the compact
    table is transformed (S cells), then re-scattered into a fresh index
    grid.  Cells that land outside the grid are dropped.
    """
    moved = C.transform(
        CellStats(sg.stats.n[None], sg.stats.s[None], sg.stats.ss[None]),
        pose[None],
    )
    moved = CellStats(moved.n[0], moved.s[0], moved.ss[0])
    fresh = empty_sparse(geom, sg.stats.n.shape[0], sg.stats.s.dtype)
    return scatter_sparse(geom, fresh, moved, moved.n > 0)


def derive_sparse_fields(sg: SparseGrid, min_points: int, cell_cfg):
    """(mean, regularized cov, valid) for the compact cell table only —
    ~40x fewer eigendecompositions than deriving the dense grid."""
    mu, cov = C.mean_cov(
        sg.stats, cell_cfg.eig_floor_ratio, cell_cfg.intensity_var_jitter,
        use_pndt=cell_cfg.use_pndt,
    )
    return mu, cov, C.valid_mask(sg.stats, min_points)


class NeighborSet(NamedTuple):
    """k fixed-map neighbors per query cell."""

    mean: jax.Array   # (..., k, 3)
    cov: jax.Array    # (..., k, 3, 3)
    valid: jax.Array  # (..., k) bool


def derive_grid_fields(grid: CellStats, min_points: int, cell_cfg):
    """Precompute (mean, regularized cov, valid) for a whole grid once per
    frame; association then only gathers."""
    mu, cov = C.mean_cov(
        grid, cell_cfg.eig_floor_ratio, cell_cfg.intensity_var_jitter,
        use_pndt=cell_cfg.use_pndt,
    )
    return mu, cov, C.valid_mask(grid, min_points)


def window_neighbors(
    geom: GridGeom,
    grid_mean,
    grid_cov,
    grid_valid,
    q_mean,
    q_cov,
    q_valid,
    k: int,
    radius: int,
    use_distribution_metric: bool = True,
) -> NeighborSet:
    """Masked top-k neighbor lookup over a static (2r+1)^2 window.

    Replaces ``Map::getClosestCells`` (both overloads, ``ndt_map.cpp:101-151``):
    the reference grows a ring until >=k occupied cells are found (capped by
    ``max_neighbour_linf_distance``); here one fixed window is gathered and a
    masked top-k taken, which returns the same cells whenever they exist in
    the window.  Metric: L2-between-distributions (Mahalanobis with pooled
    covariance, ``lookup_distribution=true``) or Euclidean mean distance.

    q_mean (Q, 3), q_cov (Q, 3, 3) must already be transformed by the current
    pose estimate (``ndt_matcher.cpp:206-214``).
    """
    Q = q_mean.shape[0]
    H, W = geom.size_y, geom.size_x
    ix, iy, inb = cell_index(geom, q_mean[..., :2])

    d = jnp.arange(-radius, radius + 1)
    dyy, dxx = jnp.meshgrid(d, d, indexing="ij")
    dxx = dxx.reshape(-1)  # (W2,)
    dyy = dyy.reshape(-1)
    nx = ix[:, None] + dxx[None, :]  # (Q, W2)
    ny = iy[:, None] + dyy[None, :]
    ok = inb[:, None] & (nx >= 0) & (nx < W) & (ny >= 0) & (ny < H)
    flat = jnp.where(ok, ny * W + nx, 0)

    gm = grid_mean.reshape(-1, 3)[flat]        # (Q, W2, 3)
    gc = grid_cov.reshape(-1, 3, 3)[flat]      # (Q, W2, 3, 3)
    gv = ok & grid_valid.reshape(-1)[flat] & q_valid[:, None]

    if use_distribution_metric:
        dist = C.mahalanobis_sq_intensity(q_mean[:, None, :], q_cov[:, None], gm, gc)
    else:
        diff = gm[..., :2] - q_mean[:, None, :2]
        dist = jnp.sum(diff * diff, axis=-1)
    dist = jnp.where(gv, dist, jnp.inf)

    neg, idx = jax.lax.top_k(-dist, k)  # (Q, k)
    sel_valid = jnp.isfinite(neg)
    take = jnp.take_along_axis
    return _sanitize(
        NeighborSet(
            mean=take(gm, idx[..., None], axis=1),
            cov=take(gc, idx[..., None, None], axis=1),
            valid=sel_valid,
        )
    )


def window_neighbors_sparse(
    geom: GridGeom,
    index,        # (H, W) int32 index grid
    t_mean,       # (S, 3) derived table fields
    t_cov,        # (S, 3, 3)
    t_valid,      # (S,)
    q_mean,
    q_cov,
    q_valid,
    k: int,
    radius: int,
    use_distribution_metric: bool = True,
) -> NeighborSet:
    """Masked top-k neighbor lookup over a static (2r+1)^2 window, sparse
    storage: gather 1 int32 per window cell from the dense index grid, then
    gather fields from the small cell table — ~12x less memory traffic
    than gathering (mean, cov) rows from a dense field grid.

    Semantics identical to :func:`window_neighbors` / the reference ring
    search ``Map::getClosestCells`` (``ndt_map.cpp:101-151``).
    """
    H, W = geom.size_y, geom.size_x
    ix, iy, inb = cell_index(geom, q_mean[..., :2])

    d = jnp.arange(-radius, radius + 1)
    dyy, dxx = jnp.meshgrid(d, d, indexing="ij")
    dxx = dxx.reshape(-1)
    dyy = dyy.reshape(-1)
    nx = ix[:, None] + dxx[None, :]  # (Q, W2)
    ny = iy[:, None] + dyy[None, :]
    ok = inb[:, None] & (nx >= 0) & (nx < W) & (ny >= 0) & (ny < H)
    flat = jnp.where(ok, ny * W + nx, 0)

    slots = index.reshape(-1)[flat]             # (Q, W2) int32
    have = ok & (slots >= 0) & q_valid[:, None]
    sl = jnp.where(have, slots, 0)
    # One fused (S, 16) row gather instead of separate mean/cov/valid
    # gathers: fewer, wider rows.
    packed = jnp.concatenate(
        [t_mean, t_cov.reshape(-1, 9),
         t_valid.astype(t_mean.dtype)[:, None],
         jnp.zeros((t_mean.shape[0], 3), t_mean.dtype)], axis=-1,
    )  # (S, 16)
    rows = packed[sl]                            # (Q, W2, 16)
    gm = rows[..., :3]
    gc = rows[..., 3:12].reshape(rows.shape[:-1] + (3, 3))
    gv = have & (rows[..., 12] > 0.5)

    if use_distribution_metric:
        dist = C.mahalanobis_sq_intensity(q_mean[:, None, :], q_cov[:, None], gm, gc)
    else:
        diff = gm[..., :2] - q_mean[:, None, :2]
        dist = jnp.sum(diff * diff, axis=-1)
    dist = jnp.where(gv, dist, jnp.inf)

    return _select_topk(dist, gm, gc, k)


def _select_topk(dist, gm, gc, k: int):
    """Pick the k nearest window cells per query.

    For small k (the reference uses n_results_nn_lookup = 2) an iterative
    masked argmin avoids ``lax.top_k``, which can lower to a full sort of the
    window axis.
    """
    take = jnp.take_along_axis
    if k <= 4:
        means, covs, valids = [], [], []
        for _ in range(k):
            i = jnp.argmin(dist, axis=-1)
            v = take(dist, i[..., None], axis=-1)[..., 0]
            means.append(take(gm, i[..., None, None], axis=-2)[..., 0, :])
            covs.append(take(gc, i[..., None, None, None], axis=-3)[..., 0, :, :])
            valids.append(jnp.isfinite(v))
            dist = jnp.where(
                jax.nn.one_hot(i, dist.shape[-1], dtype=bool), jnp.inf, dist
            )
        return _sanitize(NeighborSet(
            mean=jnp.stack(means, axis=-2),
            cov=jnp.stack(covs, axis=-3),
            valid=jnp.stack(valids, axis=-1),
        ))
    neg, idx = jax.lax.top_k(-dist, k)
    return _sanitize(NeighborSet(
        mean=take(gm, idx[..., None], axis=-2),
        cov=take(gc, idx[..., None, None], axis=-3),
        valid=jnp.isfinite(neg),
    ))


def _sanitize(nb: NeighborSet) -> NeighborSet:
    """Replace invalid (padded) neighbors with benign values so downstream
    residual Jacobians stay finite in float32 (their weights are zero)."""
    eye = jnp.broadcast_to(jnp.eye(3, dtype=nb.cov.dtype), nb.cov.shape)
    v = nb.valid[..., None]
    return NeighborSet(
        mean=jnp.where(v, nb.mean, 0.0),
        cov=jnp.where(v[..., None], nb.cov, eye),
        valid=nb.valid,
    )


def allpairs_neighbors(
    f_mean,
    f_cov,
    f_valid,
    q_mean,
    q_cov,
    q_valid,
    k: int,
    linf_cutoff: float,
    use_distribution_metric: bool = True,
) -> NeighborSet:
    """Top-k neighbors from a compacted (flat) fixed-cell list.

    Used for loop-closure refinement where the fixed submap is stored
    compacted; the spatial window of the reference ring search becomes an
    L-inf cutoff on mean positions.  f_* (F, ...), q_* (Q, ...).
    """
    diff_xy = f_mean[None, :, :2] - q_mean[:, None, :2]  # (Q, F, 2)
    within = jnp.max(jnp.abs(diff_xy), axis=-1) <= linf_cutoff
    ok = within & f_valid[None, :] & q_valid[:, None]
    if use_distribution_metric:
        dist = C.mahalanobis_sq_intensity(
            q_mean[:, None, :], q_cov[:, None], f_mean[None, :, :], f_cov[None, :]
        )
    else:
        dist = jnp.sum(diff_xy * diff_xy, axis=-1)
    dist = jnp.where(ok, dist, jnp.inf)
    neg, idx = jax.lax.top_k(-dist, k)
    sel_valid = jnp.isfinite(neg)
    return _sanitize(
        NeighborSet(
            mean=f_mean[idx],
            cov=f_cov[idx],
            valid=sel_valid,
        )
    )
