"""Per-frame SLAM front end as one jittable step function.

Re-architecture of ``LocalFuser::processScan`` (``RS/src/local_fuser/
local_fuser.cpp:99-300``) plus the submap lifecycle driven by ``NDTSlam::radarCb``
(``RS/src/ndt_slam/ndt_slam.cpp:211-223``).  The reference mutates shared
C++ containers under mutexes across five threads; here the whole front end is
a pure function ``(carry, frame) -> (carry, output)`` over fixed-shape arrays,
so it jits, scans, vmaps over sequences, and shards over device meshes.

Cadences (all deterministic, matching the reference):
  * every frame: preprocess -> scan NDT -> predict -> sliding-window GNC solve
  * every ``insertion_step`` frames: keyframe pushed on the insertion queue
  * ``insertion_delay`` frames later: keyframe exits the smoother — its scan
    is merged into the submap at the smoothed pose and becomes a pose-graph
    node (+ odometry edge)
  * when the submap trajectory reaches ``submap_size_poses``: the submap is
    finished and THE SAME frame is re-processed as the first frame of the new
    submap (``ndt_slam.cpp:219-223``)

Deliberate fixes over the reference (documented):
  * the previous-submap overlap map is transformed by the INVERSE of the
    robot pose at the switch and re-keyed on the grid; the reference applies
    the forward transform (``local_fuser.cpp:45-46``) and leaves the spatial
    index stale (``ndt_map.cpp:177-182``), which misplaces the overlap map.
  * IMU measurements pair with their own transition (the reference indexes
    one entry behind, ``ndt_matcher.cpp:360``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..geometry import compose, inverse, normalize_angle, relative
from ..ndt import cells as C
from ..ndt import grid as G
from ..ndt.cells import CellStats
from .. import preprocess as pp
from ..registration import matcher
from ..registration import residuals as R


class Frame(NamedTuple):
    """One radar frame (device arrays)."""

    intensity: jax.Array     # (A, Rb)
    azimuths: jax.Array      # (A,)
    ranges: jax.Array        # (Rb,)
    azimuth_mask: jax.Array  # (A,)
    stamp: jax.Array         # () seconds
    imu_yaw: jax.Array       # () absolute yaw reading (rad)
    index: jax.Array         # () global frame index


class ScanCells(NamedTuple):
    """Compacted scan NDT: raw sufficient statistics + derived fields."""

    stats: CellStats      # (C,)
    mean: jax.Array       # (C, 3)
    cov: jax.Array        # (C, 3, 3)
    valid: jax.Array      # (C,)


class FrontendCarry(NamedTuple):
    # sliding-window smoother (newest at index TBUF-1)
    states: jax.Array        # (TBUF, 9)
    stamps: jax.Array        # (TBUF,)
    imu_meas: jax.Array      # (TBUF,) relative yaw of transition INTO state i
    traj_len: jax.Array      # () int32 — states in current submap trajectory
    # moving-scan window (newest at index W-1), derived fields only
    scan_mean: jax.Array     # (W, C, 3)
    scan_cov: jax.Array      # (W, C, 3, 3)
    scan_valid: jax.Array    # (W, C)
    # keyframe insertion queue (FIFO, slot 0 = front)
    kq_stats: CellStats      # (KQ, C)
    kq_frame: jax.Array      # (KQ,) int32 source frame index
    kq_stamp: jax.Array      # (KQ,)
    kq_len: jax.Array        # () int32
    # submaps (sparse: dense int32 index grid + compact cell table)
    submap: G.SparseGrid     # current submap
    prev_submap: G.SparseGrid  # previous submap in current frame
    has_prev: jax.Array      # () bool
    # cached derived fields (mean/cov/valid) of both submap tables.  The
    # submap only changes at keyframe exit / submap switch, so the ~8k-cell
    # eigendecompositions are recomputed there instead of every frame
    # (the reference derives lazily per-cell inside the ring search).
    submap_fmean: jax.Array   # (S, 3)
    submap_fcov: jax.Array    # (S, 3, 3)
    submap_fvalid: jax.Array  # (S,)
    prev_fmean: jax.Array     # (S, 3)
    prev_fcov: jax.Array      # (S, 3, 3)
    prev_fvalid: jax.Array    # (S,)
    submap_origin: jax.Array  # (3,) global pose of current submap origin
    n_finished: jax.Array    # () int32
    # pose bookkeeping
    cur_pose: jax.Array      # (3,) newest robot pose in submap frame
    last_state: jax.Array    # (9,) snapshot for next submap init
    node_count: jax.Array    # () int32
    last_node_pose: jax.Array  # (3,) global pose of last emitted node
    last_node_dist: jax.Array  # () traversed distance at last node
    last_imu_yaw: jax.Array  # ()
    have_imu_prev: jax.Array  # () bool
    # finished-submap store (compacted cells; read by the loop-closure pass)
    store_cells: CellStats    # (NS, KS)
    store_origin: jax.Array   # (NS, 3) submap origin (global) at finish time
    store_root: jax.Array     # (NS,) int32 root node id per submap
    store_count: jax.Array    # () int32


class NodeRecord(NamedTuple):
    valid: jax.Array     # () bool
    node_id: jax.Array   # () int32
    pose: jax.Array      # (3,) global
    stamp: jax.Array     # ()
    traversed: jax.Array  # ()
    submap_id: jax.Array  # () int32
    frame_idx: jax.Array  # () int32 — source frame (for the loop pass)
    is_root: jax.Array   # () bool


class EdgeRecord(NamedTuple):
    valid: jax.Array     # () bool
    id_begin: jax.Array  # () int32
    id_end: jax.Array    # () int32
    trans: jax.Array     # (3,) relative SE(2)
    sqrt_information: jax.Array  # (3, 3)


class FrameOutput(NamedTuple):
    odom_pose: jax.Array      # (3,) global robot pose after this frame
    nodes: NodeRecord         # batched (2,) — keyframe exit + possible root
    edges: EdgeRecord         # batched (2,)
    submap_finished: jax.Array  # () bool — a submap was completed this frame
    finished_origin: jax.Array  # (3,) origin pose of the finished submap
    rejected: jax.Array       # () bool pose-jump rejection
    n_residuals: jax.Array    # () int32
    # capacity-saturation telemetry (padded-tensor overflow would otherwise
    # silently degrade maps).  Plain Python bools:
    # jnp scalars here would run at class-creation time and initialize the
    # XLA backend on IMPORT, which breaks multi-process entry points that
    # must call jax.distributed.initialize() first (tests/test_distributed).
    scan_saturated: jax.Array | bool = False   # scan cell budget full
    submap_saturated: jax.Array | bool = False  # submap table full
    store_saturated: jax.Array | bool = False   # submap store full
    # ScanContext descriptor of this frame's filtered scan (sensor frame),
    # emitted so the loop pass reuses it instead of re-running the whole
    # preprocessor per keyframe.  None when the driver
    # does not request it.
    sc_desc: jax.Array | None = None
    # Online-path extras (``with_scan_cells=True``): the scan's derived NDT
    # fields and max-intensity beams, so ``OnlineSlam`` never re-runs the
    # preprocessor for keyframe bookkeeping.  Offline drivers leave these
    # off — stacking them over a scanned chunk would waste HBM/host traffic.
    scan_cells: tuple | None = None        # (mean (C,3), cov (C,3,3), valid)
    beams: jax.Array | None = None         # (A, 3) angle/range/intensity
    beam_mask: jax.Array | None = None     # (A,)


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------


def init_carry(cfg: SlamConfig, initial_pose=None, dtype=jnp.float32) -> FrontendCarry:
    cap = cfg.capacity
    W = cfg.matcher.smoothing_steps
    Cc = cap.max_scan_cells
    TB = cap.traj_buffer
    KQ = cap.keyframe_queue
    geom = G.GridGeom.from_config(cfg.ndt_map)
    if initial_pose is None:
        initial_pose = jnp.zeros(3, dtype)
    init_state = jnp.zeros(9, dtype).at[R.BIAS].set(cfg.matcher.initial_imu_bias)
    return FrontendCarry(
        states=jnp.zeros((TB, 9), dtype),
        stamps=jnp.zeros((TB,), dtype),
        imu_meas=jnp.zeros((TB,), dtype),
        traj_len=jnp.int32(0),
        scan_mean=jnp.zeros((W, Cc, 3), dtype),
        scan_cov=jnp.zeros((W, Cc, 3, 3), dtype),
        scan_valid=jnp.zeros((W, Cc), bool),
        kq_stats=C.zeros((KQ, Cc), dtype),
        kq_frame=jnp.zeros((KQ,), jnp.int32),
        kq_stamp=jnp.zeros((KQ,), dtype),
        kq_len=jnp.int32(0),
        submap=G.empty_sparse(geom, cap.max_submap_cells, dtype),
        prev_submap=G.empty_sparse(geom, cap.max_submap_cells, dtype),
        has_prev=jnp.bool_(False),
        submap_fmean=jnp.zeros((cap.max_submap_cells, 3), dtype),
        submap_fcov=jnp.zeros((cap.max_submap_cells, 3, 3), dtype),
        submap_fvalid=jnp.zeros((cap.max_submap_cells,), bool),
        prev_fmean=jnp.zeros((cap.max_submap_cells, 3), dtype),
        prev_fcov=jnp.zeros((cap.max_submap_cells, 3, 3), dtype),
        prev_fvalid=jnp.zeros((cap.max_submap_cells,), bool),
        submap_origin=initial_pose.astype(dtype),
        n_finished=jnp.int32(0),
        cur_pose=jnp.zeros(3, dtype),
        last_state=init_state,
        node_count=jnp.int32(0),
        last_node_pose=initial_pose.astype(dtype),
        last_node_dist=jnp.zeros((), dtype),
        last_imu_yaw=jnp.zeros((), dtype),
        have_imu_prev=jnp.bool_(False),
        store_cells=C.zeros((cap.max_submaps, cap.max_submap_cells), dtype),
        store_origin=jnp.zeros((cap.max_submaps, 3), dtype),
        store_root=jnp.zeros((cap.max_submaps,), jnp.int32),
        store_count=jnp.int32(0),
    )


def build_scan_cells(cfg: SlamConfig, frame: Frame, sensor_to_base) -> tuple:
    """Preprocess + scan NDT (``processScan`` steps 1-2): filter, cluster,
    per-cluster moments, compact to the fixed cell budget."""
    # Scans may arrive as float16 (halves host RAM and host->device transfer
    # for long sequences — the upload, not compute, bounds offline replay
    # throughput); all math runs in float32.
    scan = pp.PolarScan(
        intensity=frame.intensity.astype(jnp.float32),
        azimuths=frame.azimuths,
        ranges=frame.ranges,
        azimuth_mask=frame.azimuth_mask,
    )
    filt = pp.filter_scan(scan, cfg.preprocessor, sensor_to_base)
    ids, num = pp.cluster_ids(filt.points, filt.mask, cfg.preprocessor)
    cell_cfg = cfg.ndt_map.cell
    stats, _ = C.from_points_compact(
        filt.points, filt.mask, ids, num, cfg.capacity.max_scan_cells,
        polar=filt.polar if cell_cfg.use_pndt else None,
        beam_cov=np.asarray(cell_cfg.beam_cov) if cell_cfg.use_pndt else None,
    )
    mu, cov = C.mean_cov(
        stats,
        cell_cfg.eig_floor_ratio,
        cell_cfg.intensity_var_jitter,
        use_pndt=cell_cfg.use_pndt,
    )
    valid = C.valid_mask(stats, cfg.ndt_map.min_points_per_cell)
    return ScanCells(stats=stats, mean=mu, cov=cov, valid=valid), filt


def _invalid_node(dtype):
    z = jnp.zeros((), dtype)
    return NodeRecord(
        valid=jnp.bool_(False), node_id=jnp.int32(0), pose=jnp.zeros(3, dtype),
        stamp=z, traversed=z, submap_id=jnp.int32(0), frame_idx=jnp.int32(0),
        is_root=jnp.bool_(False),
    )


def _invalid_edge(dtype):
    return EdgeRecord(
        valid=jnp.bool_(False), id_begin=jnp.int32(0), id_end=jnp.int32(0),
        trans=jnp.zeros(3, dtype), sqrt_information=jnp.zeros((3, 3), dtype),
    )


def _push_ring(buf, value):
    """Shift-append into a small ring buffer (newest at the end)."""
    return jnp.concatenate([buf[1:], value[None]], axis=0)


def flush_submap(cfg: SlamConfig, c: FrontendCarry) -> FrontendCarry:
    """Persist the current (unfinished) submap into the store at sequence end
    so the loop/PGO passes see every submap."""
    packed = c.submap.stats  # already compact
    idx = jnp.minimum(c.n_finished, cfg.capacity.max_submaps - 1)
    store_cells = CellStats(
        n=c.store_cells.n.at[idx].set(packed.n),
        s=c.store_cells.s.at[idx].set(packed.s),
        ss=c.store_cells.ss.at[idx].set(packed.ss),
    )
    return c._replace(store_cells=store_cells, store_count=c.n_finished + 1)


# ---------------------------------------------------------------------------
# the per-frame step
# ---------------------------------------------------------------------------


def frontend_step(cfg: SlamConfig, carry: FrontendCarry, frame: Frame,
                  sensor_to_base, with_descriptor: bool = True,
                  with_scan_cells: bool = False) -> tuple:
    """One radar frame through the front end, including the submap-completion
    re-processing of the same frame (``ndt_slam.cpp:219-223``)."""
    scan, _filt = build_scan_cells(cfg, frame, sensor_to_base)
    desc = None
    if with_descriptor:
        # ScanContext from the sensor-frame filtered returns — what the
        # reference feeds ``makeAndSaveScancontextAndKeys`` from the
        # preprocessor debug cloud (``local_fuser.h:139-141``).
        from ..loops import scancontext as SC

        desc = SC.make_descriptor(
            _filt.polar, _filt.points[:, 2], _filt.mask, cfg.scan_context
        )
    carry1, out1 = _process_scan(cfg, carry, frame, scan)

    complete = carry1.traj_len >= cfg.local_fuser.submap_size_poses

    # Persist the RUNNING submap's compact stats into its store row every
    # step (one ~213 KB dynamic row write) instead of inside the completion
    # cond below: under vmap (multi-sequence batching) a cond whose branch
    # touches the (NS, KS) store lowers to a both-branches select that
    # streams the whole ~100 MB store per step per sequence, which flattened
    # the one-device batch curve.  Rows at or
    # beyond ``store_count`` are invalid by contract, so the partial copies
    # this writes before completion are never read; the write on the
    # completion step itself stores exactly the final stats
    # (``_start_new_submap`` read the same ``c.submap.stats``).
    _sidx = jnp.minimum(carry1.n_finished, cfg.capacity.max_submaps - 1)
    _packed = carry1.submap.stats
    carry1 = carry1._replace(store_cells=CellStats(
        n=carry1.store_cells.n.at[_sidx].set(_packed.n),
        s=carry1.store_cells.s.at[_sidx].set(_packed.s),
        ss=carry1.store_cells.ss.at[_sidx].set(_packed.ss),
    ))

    def on_complete(c):
        c2 = _start_new_submap(cfg, c)
        c3, out2 = _process_scan(cfg, c2, frame, scan)
        # out2 only ever produces the root node of the new submap in slot 1;
        # keep out1's slot-0 node (keyframe exit of the old submap).
        nodes = jax.tree.map(
            lambda a, b: jnp.stack([a[0], b[1]]), out1.nodes, out2.nodes
        )
        edges = jax.tree.map(
            lambda a, b: jnp.stack([a[0], b[1]]), out1.edges, out2.edges
        )
        merged = FrameOutput(
            odom_pose=out2.odom_pose,
            nodes=nodes,
            edges=edges,
            submap_finished=jnp.bool_(True),
            finished_origin=c.submap_origin,
            rejected=out1.rejected,
            n_residuals=out1.n_residuals,
        )
        return c3, merged

    def no_complete(c):
        return c, out1

    carry2, out = jax.lax.cond(complete, on_complete, no_complete, carry1)
    # Saturation telemetry: the smallest kept scan cell still being a valid
    # distribution means valid cells may have been dropped by the top-k
    # budget; table/store fullness means scatter drops.
    cap = cfg.capacity
    scan_sat = jnp.min(scan.stats.n) > float(cfg.ndt_map.min_points_per_cell)
    out = out._replace(
        scan_saturated=scan_sat,
        submap_saturated=carry2.submap.count >= cap.max_submap_cells,
        store_saturated=carry2.n_finished >= cap.max_submaps,
        sc_desc=desc,
    )
    if with_scan_cells:
        out = out._replace(
            scan_cells=(scan.mean, scan.cov, scan.valid),
            beams=_filt.beams,
            beam_mask=_filt.beam_mask,
        )
    return carry2, out


def _start_new_submap(cfg: SlamConfig, c: FrontendCarry) -> FrontendCarry:
    """``LocalFuser::initializeNewSubmap`` (``local_fuser.cpp:40-63``)."""
    geom = G.GridGeom.from_config(cfg.ndt_map)
    switch_pose = c.states[-1, :3]  # robot pose in old submap frame
    new_origin = compose(c.submap_origin, switch_pose)
    # Previous submap expressed in the NEW submap frame (inverse transform +
    # grid re-keying — fix over ``local_fuser.cpp:45-46``).
    prev = G.transform_sparse(geom, c.submap, inverse(switch_pose))
    pf = G.derive_sparse_fields(prev, cfg.ndt_map.min_points_per_cell,
                                cfg.ndt_map.cell)
    # The finished submap's compact stats were already persisted by the
    # unconditional pre-cond row write in ``frontend_step`` (keeping the big
    # store OUT of the completion cond — see the comment there); only the
    # finished-count advances here.
    W = cfg.matcher.smoothing_steps
    Cc = cfg.capacity.max_scan_cells
    return c._replace(
        store_count=c.n_finished + 1,
        states=jnp.zeros_like(c.states),
        stamps=jnp.zeros_like(c.stamps),
        imu_meas=jnp.zeros_like(c.imu_meas),
        traj_len=jnp.int32(0),
        scan_mean=jnp.zeros_like(c.scan_mean),
        scan_cov=jnp.zeros_like(c.scan_cov),
        scan_valid=jnp.zeros_like(c.scan_valid),
        kq_stats=C.zeros((cfg.capacity.keyframe_queue, Cc), c.states.dtype),
        kq_frame=jnp.zeros_like(c.kq_frame),
        kq_stamp=jnp.zeros_like(c.kq_stamp),
        kq_len=jnp.int32(0),
        submap=G.empty_sparse(geom, cfg.capacity.max_submap_cells, c.states.dtype),
        prev_submap=prev,
        has_prev=jnp.bool_(True),
        submap_fmean=jnp.zeros_like(c.submap_fmean),
        submap_fcov=jnp.zeros_like(c.submap_fcov),
        submap_fvalid=jnp.zeros_like(c.submap_fvalid),
        prev_fmean=pf[0],
        prev_fcov=pf[1],
        prev_fvalid=pf[2],
        submap_origin=new_origin,
        n_finished=c.n_finished + 1,
        cur_pose=jnp.zeros(3, c.states.dtype),
        last_state=c.states[-1],
    )


def _process_scan(cfg: SlamConfig, c: FrontendCarry, frame: Frame,
                  scan: ScanCells) -> tuple:
    is_first = c.traj_len == 0
    return jax.lax.cond(
        is_first,
        lambda: _first_scan(cfg, c, frame, scan),
        lambda: _regular_scan(cfg, c, frame, scan),
    )


def _first_scan(cfg: SlamConfig, c: FrontendCarry, frame: Frame,
                scan: ScanCells) -> tuple:
    """First scan of a submap (``local_fuser.cpp:226-295``): seed the
    trajectory, merge the scan at the (identity) current pose, emit the
    submap root node + connecting edge."""
    dtype = c.states.dtype
    geom = G.GridGeom.from_config(cfg.ndt_map)

    init_state = jnp.zeros(9, dtype)
    init_state = init_state.at[R.X].set(c.cur_pose[0]).at[R.Y].set(c.cur_pose[1])
    init_state = init_state.at[R.TH].set(c.cur_pose[2])
    carry_vel = c.n_finished > 0
    src = c.last_state
    init_state = init_state.at[R.VX].set(jnp.where(carry_vel, src[R.VX], 0.0))
    init_state = init_state.at[R.VY].set(jnp.where(carry_vel, src[R.VY], 0.0))
    init_state = init_state.at[R.OM].set(jnp.where(carry_vel, src[R.OM], 0.0))
    init_state = init_state.at[R.AX].set(jnp.where(carry_vel, src[R.AX], 0.0))
    init_state = init_state.at[R.AY].set(jnp.where(carry_vel, src[R.AY], 0.0))
    init_state = init_state.at[R.BIAS].set(
        jnp.where(carry_vel, src[R.BIAS], cfg.matcher.initial_imu_bias)
    )

    states = _push_ring(c.states, init_state)
    stamps = _push_ring(c.stamps, frame.stamp.astype(dtype))
    imu_meas = _push_ring(c.imu_meas, jnp.zeros((), dtype))

    # Merge the scan at the current pose (identity except for the very first
    # frame with a non-trivial initial transform).
    moved = C.transform(
        CellStats(scan.stats.n[None], scan.stats.s[None], scan.stats.ss[None]),
        c.cur_pose[None],
    )
    moved = CellStats(moved.n[0], moved.s[0], moved.ss[0])
    submap = G.scatter_sparse(geom, c.submap, moved, scan.valid)
    sf = G.derive_sparse_fields(submap, cfg.ndt_map.min_points_per_cell,
                                cfg.ndt_map.cell)

    # Root node + edge from the previous node (if any).
    node_pose = c.submap_origin
    have_prev_node = c.node_count > 0
    trans = relative(c.last_node_pose, node_pose)
    traversed = c.last_node_dist + jnp.where(
        have_prev_node, jnp.linalg.norm(trans[:2]), 0.0
    )
    sqrtI = jnp.asarray(
        np.asarray(cfg.local_fuser.odom_sqrt_information), dtype
    )
    node = NodeRecord(
        valid=jnp.bool_(True),
        node_id=c.node_count,
        pose=node_pose,
        stamp=frame.stamp.astype(dtype),
        traversed=traversed,
        submap_id=c.n_finished,
        frame_idx=frame.index.astype(jnp.int32),
        is_root=jnp.bool_(True),
    )
    edge = EdgeRecord(
        valid=have_prev_node,
        id_begin=c.node_count - 1,
        id_end=c.node_count,
        trans=trans,
        sqrt_information=sqrtI,
    )
    nodes = jax.tree.map(lambda a, b: jnp.stack([a, b]), _invalid_node(dtype), node)
    edges = jax.tree.map(lambda a, b: jnp.stack([a, b]), _invalid_edge(dtype), edge)

    out = FrameOutput(
        odom_pose=compose(c.submap_origin, c.cur_pose),
        nodes=nodes,
        edges=edges,
        submap_finished=jnp.bool_(False),
        finished_origin=jnp.zeros(3, dtype),
        rejected=jnp.bool_(False),
        n_residuals=jnp.int32(0),
    )
    # Record this submap's root node id and origin in the store
    # (``root_nodes_[n_finished_submaps_] = node id``, ``local_fuser.cpp:274``).
    sidx = jnp.minimum(c.n_finished, cfg.capacity.max_submaps - 1)
    new_c = c._replace(
        states=states,
        stamps=stamps,
        imu_meas=imu_meas,
        traj_len=jnp.int32(1),
        submap=submap,
        submap_fmean=sf[0],
        submap_fcov=sf[1],
        submap_fvalid=sf[2],
        node_count=c.node_count + 1,
        last_node_pose=node_pose,
        last_node_dist=traversed,
        last_imu_yaw=frame.imu_yaw.astype(dtype),
        have_imu_prev=jnp.bool_(True),
        store_origin=c.store_origin.at[sidx].set(c.submap_origin),
        store_root=c.store_root.at[sidx].set(c.node_count),
    )
    return new_c, out


def _regular_scan(cfg: SlamConfig, c: FrontendCarry, frame: Frame,
                  scan: ScanCells) -> tuple:
    """Odometry path (``local_fuser.cpp:108-224``)."""
    dtype = c.states.dtype
    mcfg = cfg.matcher
    lcfg = cfg.local_fuser
    W = mcfg.smoothing_steps
    TB = cfg.capacity.traj_buffer
    geom = G.GridGeom.from_config(cfg.ndt_map)

    # --- IMU relative yaw (``local_fuser.cpp:110-120``) --------------------
    imu_rel = jnp.where(
        jnp.bool_(mcfg.use_imu) & c.have_imu_prev,
        normalize_angle(frame.imu_yaw.astype(dtype) - c.last_imu_yaw),
        0.0,
    )

    # --- prediction (``Matcher::predictTransform``) -------------------------
    prior_pose = c.states[-1, :3]  # pre-prediction pose = rejection reference
    dt = frame.stamp.astype(dtype) - c.stamps[-1]
    pred = matcher.predict_next_state(
        c.states[-1], dt, mcfg.use_constant_velocity_model
    )
    states = _push_ring(c.states, pred)
    stamps = _push_ring(c.stamps, frame.stamp.astype(dtype))
    imu_meas = _push_ring(c.imu_meas, imu_rel)
    traj_len = c.traj_len + 1

    # --- scan window push ----------------------------------------------------
    scan_mean = jnp.concatenate([c.scan_mean[1:], scan.mean[None]], axis=0)
    scan_cov = jnp.concatenate([c.scan_cov[1:], scan.cov[None]], axis=0)
    scan_valid = jnp.concatenate([c.scan_valid[1:], scan.valid[None]], axis=0)
    # Slots beyond the trajectory length are stale (previous submap) — mask.
    n_scans = jnp.minimum(traj_len - 1, W)
    slot_has_scan = (jnp.arange(W) >= (W - n_scans))
    scan_valid = scan_valid & slot_has_scan[:, None]

    # --- fixed maps (cached derived fields, see FrontendCarry) ---------------
    use_prev = c.has_prev & (traj_len < lcfg.submap_overlap)
    fixed = matcher.FixedMaps(
        index=(c.submap.index, c.prev_submap.index),
        mean=jnp.stack([c.submap_fmean, c.prev_fmean]),
        cov=jnp.stack([c.submap_fcov, c.prev_fcov]),
        valid=jnp.stack([c.submap_fvalid, c.prev_fvalid]),
        use=jnp.stack([jnp.bool_(True), use_prev]),
    )

    # --- sliding-window solve -------------------------------------------------
    win_states = states[TB - W - 1:]
    win_stamps = stamps[TB - W - 1:]
    win_imu = imu_meas[TB - W:]
    state_exists = jnp.arange(W + 1) >= (W + 1 - jnp.minimum(traj_len, W + 1))
    est = matcher.estimate_window(
        cfg,
        win_states,
        win_stamps,
        state_exists,
        win_imu,
        matcher.ScanWindow(mean=scan_mean, cov=scan_cov, valid=scan_valid),
        fixed,
        prior_pose,
    )
    states = states.at[TB - W - 1:].set(est.states)
    cur_pose = states[-1, :3]

    # --- keyframe queue push (``local_fuser.cpp:155-161``) --------------------
    is_keyframe = (traj_len % lcfg.insertion_step) == 0

    def push_kq(args):
        kq_stats, kq_frame, kq_stamp, kq_len = args
        idx = jnp.minimum(kq_len, cfg.capacity.keyframe_queue - 1)
        kq_stats = CellStats(
            n=kq_stats.n.at[idx].set(scan.stats.n),
            s=kq_stats.s.at[idx].set(scan.stats.s),
            ss=kq_stats.ss.at[idx].set(scan.stats.ss),
        )
        kq_frame = kq_frame.at[idx].set(frame.index.astype(jnp.int32))
        kq_stamp = kq_stamp.at[idx].set(frame.stamp.astype(dtype))
        return kq_stats, kq_frame, kq_stamp, kq_len + 1

    kq_stats, kq_frame, kq_stamp, kq_len = jax.lax.cond(
        is_keyframe,
        push_kq,
        lambda a: a,
        (c.kq_stats, c.kq_frame, c.kq_stamp, c.kq_len),
    )

    # --- delayed keyframe exit (``local_fuser.cpp:164-223``) ------------------
    delay = lcfg.insertion_delay
    do_exit = (traj_len >= delay + lcfg.insertion_step) & (
        ((traj_len - delay) % lcfg.insertion_step) == 0
    ) & (kq_len > 0)

    smoothed = states[TB - delay - 1]  # end[-(delay+1)], ``local_fuser.cpp:165``
    smoothed_pose = smoothed[:3]

    def exit_kf(args):
        submap, _sf, kq_stats, kq_frame, kq_stamp, kq_len = args
        front = CellStats(n=kq_stats.n[0], s=kq_stats.s[0], ss=kq_stats.ss[0])
        front_valid = C.valid_mask(front, cfg.ndt_map.min_points_per_cell)
        moved = C.transform(
            CellStats(front.n[None], front.s[None], front.ss[None]),
            smoothed_pose[None],
        )
        moved = CellStats(moved.n[0], moved.s[0], moved.ss[0])
        submap = G.scatter_sparse(geom, submap, moved, front_valid)
        sf = G.derive_sparse_fields(submap, cfg.ndt_map.min_points_per_cell,
                                    cfg.ndt_map.cell)
        # pop front
        kq_stats = CellStats(
            n=jnp.concatenate([kq_stats.n[1:], jnp.zeros_like(kq_stats.n[:1])]),
            s=jnp.concatenate([kq_stats.s[1:], jnp.zeros_like(kq_stats.s[:1])]),
            ss=jnp.concatenate([kq_stats.ss[1:], jnp.zeros_like(kq_stats.ss[:1])]),
        )
        kq_frame2 = jnp.concatenate([kq_frame[1:], jnp.zeros_like(kq_frame[:1])])
        kq_stamp2 = jnp.concatenate([kq_stamp[1:], jnp.zeros_like(kq_stamp[:1])])
        return submap, sf, kq_stats, kq_frame2, kq_stamp2, kq_len - 1

    front_frame = kq_frame[0]
    front_stamp = kq_stamp[0]
    submap, sfields, kq_stats, kq_frame, kq_stamp, kq_len = jax.lax.cond(
        do_exit,
        exit_kf,
        lambda a: a,
        (c.submap, (c.submap_fmean, c.submap_fcov, c.submap_fvalid),
         kq_stats, kq_frame, kq_stamp, kq_len),
    )

    node_pose = compose(c.submap_origin, smoothed_pose)
    trans = relative(c.last_node_pose, node_pose)
    traversed = c.last_node_dist + jnp.linalg.norm(trans[:2])
    sqrtI = jnp.asarray(np.asarray(lcfg.odom_sqrt_information), dtype)
    node = NodeRecord(
        valid=do_exit,
        node_id=c.node_count,
        pose=node_pose,
        stamp=front_stamp,
        traversed=traversed,
        submap_id=c.n_finished,
        frame_idx=front_frame,
        is_root=jnp.bool_(False),
    )
    edge = EdgeRecord(
        valid=do_exit,
        id_begin=c.node_count - 1,
        id_end=c.node_count,
        trans=trans,
        sqrt_information=sqrtI,
    )
    nodes = jax.tree.map(
        lambda a, b: jnp.stack([a, b]), node, _invalid_node(dtype)
    )
    edges = jax.tree.map(
        lambda a, b: jnp.stack([a, b]), edge, _invalid_edge(dtype)
    )

    out = FrameOutput(
        odom_pose=compose(c.submap_origin, cur_pose),
        nodes=nodes,
        edges=edges,
        submap_finished=jnp.bool_(False),
        finished_origin=jnp.zeros(3, dtype),
        rejected=est.rejected,
        n_residuals=est.n_residuals,
    )
    new_c = c._replace(
        states=states,
        stamps=stamps,
        imu_meas=imu_meas,
        traj_len=traj_len,
        scan_mean=scan_mean,
        scan_cov=scan_cov,
        scan_valid=scan_valid,
        kq_stats=kq_stats,
        kq_frame=kq_frame,
        kq_stamp=kq_stamp,
        kq_len=kq_len,
        submap=submap,
        submap_fmean=sfields[0],
        submap_fcov=sfields[1],
        submap_fvalid=sfields[2],
        cur_pose=cur_pose,
        node_count=c.node_count + jnp.where(do_exit, 1, 0),
        last_node_pose=jnp.where(do_exit, node_pose, c.last_node_pose),
        last_node_dist=jnp.where(do_exit, traversed, c.last_node_dist),
        last_imu_yaw=frame.imu_yaw.astype(dtype),
        have_imu_prev=jnp.bool_(True),
    )
    return new_c, out
