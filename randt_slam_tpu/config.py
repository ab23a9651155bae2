"""Typed configuration for the radar NDT SLAM engine.

Mirrors the reference parameter tree (RaNDT SLAM,
``RS/include/ndt_slam/ndt_slam_parameters.h`` and the imperative loader in
``RS/src/ndt_slam/ndt_slam.cpp:397-712``) as frozen dataclasses, including the
derived parameters the reference computes at load time:

* NDT map size is given in meters and divided by the resolution
  (``ndt_slam.cpp:653-654``), likewise the OGM (``:664-667``).
* ``n_clusters = (2*max_range/resolution)**2`` (``:691``).
* ``insertion_delay = smoothing_steps + 1`` (``:580``).
* loop-closure defaults cascade from matcher params (``:573-586,614-616``).

Additional capacity parameters (padded tensor sizes) live in
:class:`CapacityConfig`; they have no reference counterpart because the
reference uses dynamically sized C++ containers.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Leaf configs (one per reference parameter struct)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CellConfig:
    """NDT cell parameters (``NDTCellParameters``)."""

    use_pndt: bool = False
    # 3x3 sensor covariance of a single beam in polar coordinates
    # (angle, range, intensity); reference key ``/ndt_cell/beam_cov``.
    beam_cov: tuple = (
        (0.0349208, 0.0, 0.0),
        (0.0, 0.001, 0.0),
        (0.0, 0.0, 10.0),
    )
    # Eigenvalue floor ratio for the 2x2 position covariance block
    # (``ndt_cell.cpp:107``): lambda_min >= ratio * lambda_max.
    eig_floor_ratio: float = 0.001
    # Additive jitter on the intensity variance (``ndt_cell.cpp:111``).
    intensity_var_jitter: float = 1e-6


@dataclass(frozen=True)
class MapConfig:
    """NDT map parameters (``NDTMapParameters``).

    ``size_x``/``size_y`` are in **cells** (already divided by resolution,
    as the reference does at ``ndt_slam.cpp:653-654``).
    """

    size_x: int = 400
    size_y: int = 400
    resolution: float = 3.5
    min_points_per_cell: int = 10
    # Reference key ``max_neighbor_linf_distance`` (meters).
    max_neighbour_linf_distance: float = 10.0
    cell: CellConfig = field(default_factory=CellConfig)

    @property
    def n_cells(self) -> int:
        return self.size_x * self.size_y

    @property
    def nn_window_radius(self) -> int:
        """Static neighbor-search window radius in cells.

        The reference ring search (``ndt_map.cpp:101-151``) grows the window
        until >= k occupied cells are found, breaking once the radius counter
        reaches ``int(max_linf/resolution)``; the last radius actually
        *evaluated* is therefore ``int(max_linf/resolution) - 1``.  This
        build gathers one fixed window of that radius and takes a masked
        top-k over it (see ``ndt/grid.py``).
        """
        r = int(self.max_neighbour_linf_distance / self.resolution) - 1
        return max(1, r)


@dataclass(frozen=True)
class OGMConfig:
    """Occupancy-grid-map parameters (``OGMMapParameters``).

    ``size_x``/``size_y`` in cells (meters already divided by resolution).
    """

    size_x: int = 900
    size_y: int = 400
    resolution: float = 0.1
    submap_size_x: int = 0  # derived: map extent in OGM cells
    submap_size_y: int = 0


@dataclass(frozen=True)
class PreprocessorConfig:
    """Radar preprocessor parameters (``RadarPreprocessorParameters``)."""

    min_range: float = 2.0
    max_range: float = 100.0
    min_intensity: float = 70.0
    beam_distance_increment_threshold: float = 0.12
    min_points_per_cell: int = 10  # mirrored from map config by the loader
    n_clusters: int = 0  # derived: (2*max_range/resolution)**2

    @property
    def cluster_row_size(self) -> int:
        """Side length of the cluster grid (``grid.cpp:8``)."""
        return int(math.sqrt(self.n_clusters)) if self.n_clusters else 0

    @property
    def cluster_resolution(self) -> float:
        """Cluster grid pitch (``grid.cpp:9``)."""
        rs = self.cluster_row_size
        return (2.0 * self.max_range / rs) if rs else 0.0


@dataclass(frozen=True)
class MatcherConfig:
    """Registration parameters (``NDTMatcherParameters``)."""

    # 8x8 square-root information of the motion model, row-major.
    motion_sqrt_information: tuple = tuple(
        tuple(row)
        for row in np.diag([1.0, 1.0, 10.0, 1.0, 3.0, 0.1, 20.0, 60.0]).tolist()
    )
    covariance_scaling_factor: float = 0.01
    use_imu: bool = False
    weight_imu: float = 64.0
    weight_imu_bias: float = 750000.1
    initial_imu_bias: float = 0.0
    gnc_steps: int = 2
    smoothing_steps: int = 3
    loss_function_scale: float = 1.0
    loss_function_convexity: float = -2.0
    gnc_control_parameter_divisor: float = 1.1
    max_iteration: int = 200
    pose_reject_translation: float = 5.0
    pose_reject_rotation: float = 2.0
    n_results_nn_lookup: int = 2
    ndt_weight: float = 5000.0
    use_intensity_as_dimension: bool = True
    use_constant_velocity_model: bool = True
    lookup_distribution: bool = True  # L2-between-distributions NN metric
    # Correlative-scan-matching (global search) parameters.
    csm_window_linear: float = 4.5
    csm_window_angular: float = 0.45
    csm_linear_step: float = 0.4
    csm_cost_threshold: float = 0.82
    csm_max_px_accurate_range: float = 4.0
    csm_n_iter: int = 2
    # No reference counterpart: iteration cap of the inner Levenberg-Marquardt loop per GNC
    # step.  The reference lets Ceres run up to ``max_iteration``; the batched
    # solver converges in far fewer damped steps on these tiny problems.
    lm_max_iterations: int = 25
    lm_tolerance: float = 1e-7
    # Ceres ``Solver::Options::function_tolerance`` (default 1e-6), which the
    # reference leaves at its default (``ndt_matcher.cpp:371-381``): an
    # accepted LM step improving the cost by less than this relative amount
    # terminates the inner loop.
    lm_function_tolerance: float = 1e-6


@dataclass(frozen=True)
class ScanContextConfig:
    """ScanContext descriptor parameters (``ScanContextParameters``)."""

    num_ring: int = 30
    num_sector: int = 120
    max_radius: float = 90.0
    # 50 (reference default is 100, ``Scancontext.h``): the round-4 recall
    # sensitivity sweep (``acceptance/loop_sweep.json``, OXFORD_RESULTS §6)
    # measured 100 -> 50 as +4% recall at ZERO additional bad edges on the
    # revisit window — adopted.  Reference YAMLs that set
    # the key explicitly still override this via ``from_reference_yaml``.
    num_exclude_recent: int = 50
    num_candidates: int = 10
    search_ratio: float = 1.0
    dist_threshold: float = 0.7
    tree_making_period: int = 10
    assumed_drift: float = 0.05
    odom_eps: float = 4.0
    odom_weight: float = 0.05
    intensity_factor: float = 0.01

    @property
    def unit_sector_angle_deg(self) -> float:
        return 360.0 / float(self.num_sector)


@dataclass(frozen=True)
class LocalFuserConfig:
    """Front-end parameters (``LocalFuserParameters``)."""

    insertion_step: int = 2
    insertion_delay: int = 4  # derived: smoothing_steps + 1
    submap_size_poses: int = 20
    submap_overlap: int = 10
    loop_closure_max_cs_divergence: float = 4.5
    loop_closure_weight: float = 1.0
    loop_closure_gnc_steps: int = 10
    loop_closure_scale: float = 0.5
    use_intensity_in_loop_closure: bool = True
    use_scan_context_as_loop_closure: bool = True
    compute_dfs_loop_closure: bool = False
    # Extension (no reference counterpart): run the batched CSM global
    # search (``global_grid_search``) to pre-align ScanContext candidates
    # before GNC refinement.  Widens the loop-closure convergence basin from
    # ~1-2 m to the CSM window at the cost of one batched scoring pass.
    csm_prealign_loops: bool = False
    # Extension (no reference counterpart): odometry-consistency gate on
    # refined loop edges.  A refined loop pose whose discrepancy against the
    # odometry-chained relative pose exceeds what odometry drift over the
    # traversed span can explain is a wrong-basin NDT refinement (aliased
    # structure) that slipped under the CS-divergence gate; yaw is the
    # decisive axis (a wrong relative yaw between two far-apart anchors bends
    # the whole unconstrained arc between them at PGO).  Limits grow linearly
    # with traversed distance between the edge endpoints.
    # Envelope calibration (10-12-32 full-length acceptance run, 473 edges):
    # genuine edges' yaw discrepancy vs the odometry chain tracks odometry
    # yaw drift — up to 2.43 deg at a 9.0 km traversed span (~0.027 deg/100m)
    # — while the one wrong-basin edge sat at 4.29 deg over 2.8 km.  The
    # rejection asymmetry is steep (one bad edge bends the whole graph; a
    # rejected good edge is redundant among hundreds), so the envelope hugs
    # the measured drift with ~1.7x margin rather than generous slack.
    loop_odom_gate: bool = True
    loop_odom_gate_rot_base_deg: float = 1.5
    loop_odom_gate_rot_deg_per_100m: float = 0.03
    loop_odom_gate_trans_base_m: float = 3.0
    loop_odom_gate_trans_pct: float = 0.5   # % of traversed span
    max_data_association_mahalanobis_dist: float = 0.5
    loop_sqrt_information: tuple = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 0.1))
    # Odometry edge sqrt-information, fixed in the reference
    # (``local_fuser.cpp:203-205``).
    odom_sqrt_information: tuple = ((10.0, 0.0, 0.0), (0.0, 10.0, 0.0), (0.0, 0.0, 50.0))


@dataclass(frozen=True)
class GlobalFuserConfig:
    """Pose-graph back end parameters (``GlobalFuserParameters``)."""

    use_robust_loss: bool = False
    loss_function_scale: float = 750.0
    max_iterations: int = 100  # GN iterations of the batched solver
    tolerance: float = 1e-9
    # --- Extensions (no reference counterpart; the defaults
    # reproduce ``global_fuser.cpp:17-23`` exactly: Huber on ALL edges).
    # "dcs" = Dynamic Covariance Scaling (Agarwal et al., ICRA 2013), a
    # redescending kernel that suppresses gross loop-closure outliers far
    # harder than Huber's linear tail.
    #
    # STATUS: "huber" matches the reference's only robust option
    # (``global_fuser.cpp:17-23``); it is what ``use_robust_loss: true``
    # selects for reference-parity runs.  The SHIPPED defense against bad
    # loop edges is ``dcs_loop_defense`` below.
    robust_kernel: str = "huber"        # "huber" | "dcs"
    # Apply the robust kernel only to non-consecutive (loop) edges; odometry
    # edges stay quadratic (they are trusted by construction).
    robust_loop_edges_only: bool = False
    # Solve the quadratic problem to convergence first, then re-solve with
    # robust weights from that solution — at the least-squares optimum the
    # residual of an inconsistent loop edge concentrates on itself, so IRLS
    # identifies outliers without suppressing genuine drift-corrupted loops.
    robust_two_stage: bool = False
    # --- SHIPPED defense against bad loop edges ----------------------------
    # Dynamic Covariance Scaling on LOOP edges only, applied two-stage
    # (quadratic solve first, then DCS-weighted re-solve).  Independent of
    # the reference-parity ``use_robust_loss`` knob so it survives loading
    # the reference YAMLs (which set ``use_robust_loss: false`` for Oxford).
    # Round-4's azimuth-jitter ablation showed two bad edges slipping BOTH
    # the CS and odometry-consistency gates and making SLAM worse than
    # odometry (9.07 vs 5.06 m ATE) — DCS two-stage is the residual-domain
    # backstop for exactly that case (``tests/test_pose_graph.py``).
    # Clean-run loop edges sit far inside the unit-weight region
    # (w == 1 for ||r|| <= dcs_scale; median whitened loop residual ~0.05),
    # so the clean acceptance rows are unaffected.
    dcs_loop_defense: bool = True
    # DCS phi = dcs_scale^2, in whitened-residual units of the loop edges
    # (sqrtI ~ diag(1, 1, 0.1)): genuine loops land well under 1; the
    # jitter-ablation outliers (2.9-3.6 m) land at w < 0.05.
    dcs_scale: float = 1.0


@dataclass(frozen=True)
class CapacityConfig:
    """Fixed tensor capacities (padded shapes).

    No reference counterpart; the reference grows ``std::vector``s.  These cap
    the padded array sizes the jitted pipeline is compiled for.
    """

    max_points: int = 8192        # filtered points per scan
    max_scan_cells: int = 512     # compacted NDT cells per scan
    max_azimuths: int = 512       # beams per scan (raytracing / peak list)
    max_range_bins: int = 1024    # polar image width fed to the preprocessor
    max_submap_cells: int = 4096  # compacted cells per finished submap
    max_submaps: int = 512        # finished-submap store capacity
    max_nodes: int = 8192         # pose-graph nodes per sequence
    max_edges: int = 16384        # pose-graph edges per sequence
    max_keyframes: int = 8192     # ScanContext database size
    traj_buffer: int = 8          # sliding-window state ring buffer length
    keyframe_queue: int = 4       # pending keyframe maps (insertion queues)


@dataclass(frozen=True)
class SlamConfig:
    """Top-level configuration (``NDTSlamParameters``)."""

    use_imu: bool = False
    visualize_ogm: bool = False
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    ndt_map: MapConfig = field(default_factory=MapConfig)
    ogm: OGMConfig = field(default_factory=OGMConfig)
    preprocessor: PreprocessorConfig = field(default_factory=PreprocessorConfig)
    scan_context: ScanContextConfig = field(default_factory=ScanContextConfig)
    local_fuser: LocalFuserConfig = field(default_factory=LocalFuserConfig)
    global_fuser: GlobalFuserConfig = field(default_factory=GlobalFuserConfig)
    capacity: CapacityConfig = field(default_factory=CapacityConfig)

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Derivations (mirror of ``NDTSlam::readParameters`` arithmetic)
# ---------------------------------------------------------------------------


def derive(cfg: SlamConfig) -> SlamConfig:
    """Apply the reference's derived-parameter arithmetic.

    Expects ``ndt_map.size_*``/``ogm.size_*`` in METERS (as in the YAML) and
    returns a config with them converted to cells plus all cascades applied.
    """
    m = cfg.ndt_map
    map_cfg = dataclasses.replace(
        m,
        size_x=int(m.size_x / m.resolution),
        size_y=int(m.size_y / m.resolution),
    )
    o = cfg.ogm
    ogm_cfg = dataclasses.replace(
        o,
        size_x=int(o.size_x / o.resolution),
        size_y=int(o.size_y / o.resolution),
        submap_size_x=int(map_cfg.size_x * map_cfg.resolution / o.resolution),
        submap_size_y=int(map_cfg.size_y * map_cfg.resolution / o.resolution),
    )
    p = cfg.preprocessor
    pre_cfg = dataclasses.replace(
        p,
        n_clusters=int((2.0 * p.max_range / map_cfg.resolution) ** 2),
        min_points_per_cell=map_cfg.min_points_per_cell,
    )
    lf = dataclasses.replace(
        cfg.local_fuser,
        insertion_delay=cfg.matcher.smoothing_steps + 1,
    )
    mat = dataclasses.replace(cfg.matcher, use_imu=cfg.use_imu)
    return dataclasses.replace(
        cfg,
        ndt_map=map_cfg,
        ogm=ogm_cfg,
        preprocessor=pre_cfg,
        local_fuser=lf,
        matcher=mat,
    )


# ---------------------------------------------------------------------------
# YAML loading (accepts the reference's ROS-style layered YAML files)
# ---------------------------------------------------------------------------

_REF_KEYMAP = {
    # (yaml section, yaml key) -> (attr path, transform)
    ("ndt_slam", "use_imu"): ("use_imu", None),
    ("ndt_slam", "visualize_ogm"): ("visualize_ogm", None),
    ("global_fuser", "use_robust_loss"): ("global_fuser.use_robust_loss", None),
    ("global_fuser", "loss_function_scale"): ("global_fuser.loss_function_scale", None),
    ("local_fuser", "insertion_step"): ("local_fuser.insertion_step", None),
    ("local_fuser", "submap_size_poses"): ("local_fuser.submap_size_poses", None),
    ("local_fuser", "submap_overlap"): ("local_fuser.submap_overlap", None),
    ("local_fuser", "loop_closure_max_cs_divergence"): (
        "local_fuser.loop_closure_max_cs_divergence", None),
    ("local_fuser", "loop_closure_weight"): ("local_fuser.loop_closure_weight", None),
    ("local_fuser", "loop_closure_gnc_steps"): ("local_fuser.loop_closure_gnc_steps", None),
    ("local_fuser", "loop_closure_scale"): ("local_fuser.loop_closure_scale", None),
    ("local_fuser", "use_intensity_in_loop_closure"): (
        "local_fuser.use_intensity_in_loop_closure", None),
    ("local_fuser", "use_scan_context_as_loop_closure"): (
        "local_fuser.use_scan_context_as_loop_closure", None),
    ("local_fuser", "compute_dfs_loop_closure"): (
        "local_fuser.compute_dfs_loop_closure", None),
    ("local_fuser", "max_data_association_mahalanobis_dist"): (
        "local_fuser.max_data_association_mahalanobis_dist", None),
    ("local_fuser", "loop_sqrtI"): (
        "local_fuser.loop_sqrt_information", lambda v: _colmajor_3x3(v)),
    ("scan_context", "num_ring"): ("scan_context.num_ring", None),
    ("scan_context", "num_sector"): ("scan_context.num_sector", None),
    ("scan_context", "max_radius"): ("scan_context.max_radius", None),
    ("scan_context", "num_exclude_recent"): ("scan_context.num_exclude_recent", None),
    ("scan_context", "num_candidates_from_tree"): ("scan_context.num_candidates", None),
    ("scan_context", "search_ratio"): ("scan_context.search_ratio", None),
    ("scan_context", "dist_thresh"): ("scan_context.dist_threshold", None),
    ("scan_context", "tree_making_period"): ("scan_context.tree_making_period", None),
    ("scan_context", "assumed_drift"): ("scan_context.assumed_drift", None),
    ("scan_context", "odom_eps"): ("scan_context.odom_eps", None),
    ("scan_context", "odom_weight"): ("scan_context.odom_weight", None),
    ("scan_context", "intensity_factor"): ("scan_context.intensity_factor", None),
    ("ndt_matcher", "motion_sqrtI"): (
        "matcher.motion_sqrt_information", lambda v: _colmajor_8x8(v)),
    ("ndt_matcher", "covariance_scaling_factor"): (
        "matcher.covariance_scaling_factor", None),
    ("ndt_matcher", "weight_imu"): ("matcher.weight_imu", None),
    ("ndt_matcher", "weight_imu_bias"): ("matcher.weight_imu_bias", None),
    ("ndt_matcher", "initial_imu_bias"): ("matcher.initial_imu_bias", None),
    ("ndt_matcher", "gnc_steps"): ("matcher.gnc_steps", None),
    ("ndt_matcher", "smoothing_steps"): ("matcher.smoothing_steps", None),
    ("ndt_matcher", "loss_function_scale"): ("matcher.loss_function_scale", None),
    ("ndt_matcher", "loss_function_convexity"): ("matcher.loss_function_convexity", None),
    ("ndt_matcher", "gnc_control_parameter_divisor"): (
        "matcher.gnc_control_parameter_divisor", None),
    ("ndt_matcher", "max_iteration"): ("matcher.max_iteration", None),
    ("ndt_matcher", "pose_reject_translation"): ("matcher.pose_reject_translation", None),
    ("ndt_matcher", "pose_reject_rotation"): ("matcher.pose_reject_rotation", None),
    ("ndt_matcher", "n_results_nn_lookup"): ("matcher.n_results_nn_lookup", None),
    ("ndt_matcher", "ndt_weight"): ("matcher.ndt_weight", None),
    ("ndt_matcher", "use_intensity_as_dimension"): (
        "matcher.use_intensity_as_dimension", None),
    ("ndt_matcher", "use_constant_velocity_model"): (
        "matcher.use_constant_velocity_model", None),
    ("ndt_matcher", "lookup_distribution"): ("matcher.lookup_distribution", None),
    ("ndt_matcher", "csm_window_linear"): ("matcher.csm_window_linear", None),
    ("ndt_matcher", "csm_window_angular"): ("matcher.csm_window_angular", None),
    ("ndt_matcher", "csm_linear_step"): ("matcher.csm_linear_step", None),
    ("ndt_matcher", "csm_cost_threshold"): ("matcher.csm_cost_threshold", None),
    ("ndt_matcher", "csm_max_px_accurate_range"): (
        "matcher.csm_max_px_accurate_range", None),
    ("ndt_matcher", "csm_n_iter"): ("matcher.csm_n_iter", None),
    ("ndt_map", "size_x"): ("ndt_map.size_x", None),
    ("ndt_map", "size_y"): ("ndt_map.size_y", None),
    ("ndt_map", "resolution"): ("ndt_map.resolution", None),
    ("ndt_map", "min_points_per_cell"): ("ndt_map.min_points_per_cell", None),
    ("ndt_map", "max_neighbor_linf_distance"): (
        "ndt_map.max_neighbour_linf_distance", None),
    ("ogm_map", "size_x"): ("ogm.size_x", None),
    ("ogm_map", "size_y"): ("ogm.size_y", None),
    ("ogm_map", "resolution"): ("ogm.resolution", None),
    ("ndt_cell", "use_pndt"): ("ndt_map.cell.use_pndt", None),
    ("ndt_cell", "beam_cov"): ("ndt_map.cell.beam_cov", lambda v: _colmajor_3x3(v)),
    ("radar_preprocessor", "max_range"): ("preprocessor.max_range", None),
    ("radar_preprocessor", "min_range"): ("preprocessor.min_range", None),
    ("radar_preprocessor", "min_intensity"): ("preprocessor.min_intensity", None),
    ("radar_preprocessor", "beam_distance_increment_threshold"): (
        "preprocessor.beam_distance_increment_threshold", None),
}


def _colmajor_3x3(v: Sequence[float]) -> tuple:
    # The reference feeds the flat YAML list into an Eigen matrix, which is
    # column-major (``ndt_slam.cpp:513,556,683``); all shipped matrices are
    # symmetric so the distinction is moot, but we reproduce it exactly.
    a = np.asarray(v, dtype=np.float64).reshape(3, 3).T
    return tuple(tuple(row) for row in a.tolist())


def _colmajor_8x8(v: Sequence[float]) -> tuple:
    a = np.asarray(v, dtype=np.float64).reshape(8, 8).T
    return tuple(tuple(row) for row in a.tolist())


def _set_path(obj: Any, path: str, value: Any) -> Any:
    head, _, rest = path.partition(".")
    if not rest:
        return dataclasses.replace(obj, **{head: value})
    sub = getattr(obj, head)
    return dataclasses.replace(obj, **{head: _set_path(sub, rest, value)})


def from_reference_yaml(*yaml_paths: str, capacity: CapacityConfig | None = None) -> SlamConfig:
    """Build a config from reference-style layered YAML files.

    Later files override earlier ones (base + environment overlay, matching
    ``ndt_slam.launch``'s rosparam layering).  Sizes are interpreted in meters
    and converted through :func:`derive`.
    """
    import yaml

    merged: dict = {}
    for path in yaml_paths:
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        for section, kv in doc.items():
            if isinstance(kv, Mapping):
                merged.setdefault(section, {}).update(kv)

    cfg = SlamConfig()
    for (section, key), (attr, tf) in _REF_KEYMAP.items():
        if section in merged and key in merged[section]:
            v = merged[section][key]
            if tf is not None:
                v = tf(v)
            cfg = _set_path(cfg, attr, v)
    # Absent-key cascades from matcher params (``ndt_slam.cpp:573-586,614-616``):
    # the reference falls back to the matcher value only when the YAML omits
    # the loop-closure key.
    lf_yaml = merged.get("local_fuser", {})
    if "loop_closure_gnc_steps" not in lf_yaml:
        cfg = _set_path(cfg, "local_fuser.loop_closure_gnc_steps",
                        cfg.matcher.gnc_steps)
    if "loop_closure_scale" not in lf_yaml:
        cfg = _set_path(cfg, "local_fuser.loop_closure_scale",
                        cfg.matcher.loss_function_scale)
    if "use_intensity_in_loop_closure" not in lf_yaml:
        cfg = _set_path(cfg, "local_fuser.use_intensity_in_loop_closure",
                        cfg.matcher.use_intensity_as_dimension)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, capacity=capacity)
    return derive(cfg)


def oxford_config(**overrides) -> SlamConfig:
    """The Oxford Radar RobotCar configuration (``parameters_oxford.yaml``),
    with derived parameters applied.  Defaults above already encode the
    Oxford values; this just runs the meter->cell derivation.

    Note the YAML's ``size_x: 400`` comment claims cells, but the reference
    loader divides by the resolution regardless (``ndt_slam.cpp:653-654``) —
    the actual Oxford NDT grid is 400 m / 3.5 m = 114x114 cells.
    """
    cfg = SlamConfig(
        ndt_map=MapConfig(size_x=400, size_y=400),  # meters -> 114 cells
        ogm=OGMConfig(size_x=90, size_y=40, resolution=0.1),
    )
    cfg = derive(cfg)
    for k, v in overrides.items():
        cfg = _set_path(cfg, k, v)
    return cfg


def synthetic_config(**overrides) -> SlamConfig:
    """Moderate-scale preset tuned for the synthetic radar world
    (``io/synthetic.py``); the CLI's ``--config synthetic`` choice."""
    cfg = SlamConfig(
        ndt_map=MapConfig(size_x=300, size_y=300, resolution=3.0,
                          min_points_per_cell=8,
                          max_neighbour_linf_distance=9.0),
        preprocessor=PreprocessorConfig(min_range=2.0, max_range=80.0,
                                        min_intensity=40.0,
                                        beam_distance_increment_threshold=1.0),
        matcher=MatcherConfig(smoothing_steps=3, gnc_steps=2,
                              lm_max_iterations=12),
        local_fuser=LocalFuserConfig(submap_size_poses=20, submap_overlap=10,
                                     insertion_step=2),
        capacity=CapacityConfig(max_points=4096, max_scan_cells=256,
                                max_azimuths=256, max_range_bins=256,
                                max_submap_cells=1024, max_submaps=8),
    )
    cfg = derive(cfg)
    for k, v in overrides.items():
        cfg = _set_path(cfg, k, v)
    return cfg


def indoor_config(**overrides) -> SlamConfig:
    """A small-scale indoor-style configuration (cf. ``parameters_indoor.yaml``
    scale): 50 m maps, sub-meter cells, IMU enabled."""
    cfg = SlamConfig(
        use_imu=True,
        ndt_map=MapConfig(size_x=50, size_y=50, resolution=1.0,
                          min_points_per_cell=6,
                          max_neighbour_linf_distance=6.0),
        ogm=OGMConfig(size_x=90, size_y=40, resolution=0.1),
        preprocessor=PreprocessorConfig(min_range=0.5, max_range=25.0,
                                        min_intensity=55.0,
                                        beam_distance_increment_threshold=0.04),
        matcher=MatcherConfig(pose_reject_translation=2.0),
        capacity=CapacityConfig(max_points=4096, max_scan_cells=256,
                                max_azimuths=512, max_range_bins=512,
                                max_submap_cells=1024),
    )
    cfg = derive(cfg)
    for k, v in overrides.items():
        cfg = _set_path(cfg, k, v)
    return cfg
