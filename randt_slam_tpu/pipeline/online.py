"""Online (incremental) SLAM: the reference's live mode, ROS-free.

``NDTSlam::initializeOnline`` (``RS/src/ndt_slam/ndt_slam.cpp:67-92``) runs
the front end on the subscriber callback plus three timers (loop search, pose
-graph optimization, raytracing) that mutate shared state under mutexes.
This build keeps the same cadences but runs them synchronously between frames
on functional state — deterministic, lock-free, and with the one feedback
path the offline mode lacks: pose-graph results re-anchor the ACTIVE submap
(``LocalFuser::updateSubmaps``), steering subsequent odometry and edges.

Cadences (configurable, defaults match the reference timer frequencies at the
4 Hz radar rate):
  * loop search every ``loop_every`` frames  (0.8 Hz timer -> ~5 frames)
  * PGO + re-anchoring every ``pgo_every`` frames (0.2 Hz -> ~20 frames),
    with the reference's ``max_update_index`` gating of loop edges
    (``ndt_slam.cpp:351-360``).
"""

from __future__ import annotations

from functools import partial
from time import perf_counter as _pc

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..geometry import compose, inverse
from ..graph import pose_graph as PG
from ..loops import scancontext as SC
from ..ndt import cells as C
from ..ndt import divergence as D
from ..registration import matcher
from . import frontend as F


class OnlineSlam:
    """Incremental driver: feed frames one at a time, read poses/graph."""

    def __init__(self, cfg: SlamConfig, sensor_to_base=None,
                 initial_pose=None, loop_every: int = 5, pgo_every: int = 20):
        self.cfg = cfg
        self.s2b = jnp.zeros(3) if sensor_to_base is None else jnp.asarray(
            sensor_to_base, jnp.float32)
        self.carry = F.init_carry(cfg, initial_pose=initial_pose)
        self.loop_every = loop_every
        self.pgo_every = pgo_every
        self._step = jax.jit(partial(F.frontend_step, cfg,
                                     sensor_to_base=self.s2b,
                                     with_scan_cells=True))
        self._features = jax.jit(self._node_features)
        self._refine = jax.jit(partial(self._refine_and_gate, cfg))
        # Padded ScanContext database: fixed (max_nodes, ...) shapes so the
        # jitted detector never recompiles as keyframes accumulate (the
        # incremental kd-tree rebuild of ``Scancontext.cpp:275-287`` becomes
        # one static-shape kNN).  DEVICE-resident and updated in place at
        # keyframe exit — a loop cadence queries it without re-uploading the
        # whole padded database.
        cap = cfg.capacity.max_nodes
        sc = cfg.scan_context
        self._sc_desc = jnp.zeros((cap, sc.num_ring, sc.num_sector),
                                  jnp.float32)
        self._sc_key = jnp.zeros((cap, sc.num_ring), jnp.float32)
        self._sc_pos = jnp.zeros((cap, 2), jnp.float32)
        self._sc_trav = jnp.zeros((cap,), jnp.float32)
        self._detect = jax.jit(partial(SC.detect, cfg=sc))
        self._frame_count = 0
        # host-side graph state (the reference's nodes_/edges_ containers)
        self.node_pose: list[np.ndarray] = []
        self.node_stamp: list[float] = []
        self.node_traversed: list[float] = []
        self.node_submap: list[int] = []
        self.node_frame: list[int] = []
        self.node_is_root: list[bool] = []
        self.edges: list[tuple] = []  # (begin, end, trans, sqrtI)
        self.n_loop_edges = 0
        # ScanContext database
        self.sc_desc: list[np.ndarray] = []
        self.sc_keys: list[np.ndarray] = []
        self._pending_loop_queries: list[int] = []
        self._node_cells: dict[int, tuple] = {}
        self._recent_frames: dict[int, object] = {}
        # per-frame features harvested from each step's FrameOutput — the
        # keyframe exit (``insertion_delay`` frames later) reuses these
        # instead of re-running the preprocessor
        self._recent_feats: dict[int, tuple] = {}
        # per-frame pose-jump rejections (``ndt_matcher.cpp:411-422``) —
        # surfaced so online acceptance metrics report real counts
        self.rejected_trace: list[bool] = []
        self.odom_trace: list[np.ndarray] = []
        # per-submap OGM counting grids (online raytrace cadence)
        self._count_grids: dict[int, np.ndarray] = {}
        # per-stage wall clocks (medians surface in the online metrics)
        self.stage_walls: dict[str, list] = {
            "step": [], "record": [], "loops": [], "pgo": []}

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _refine_and_gate(cfg, sub, n_t, s_t, ss_t, root_pose, match_pose,
                         yaw, q_pose, m_mean, m_cov, m_valid):
        """GNC loop refinement + CS-divergence gate as ONE jitted call
        (``estimateLoopConstraint`` + ``calculateCSDivergence``).

        Everything the candidate needs happens inside the jit — the guess
        composition, the submap-row gather from the carry's store tables and
        the store-cell (mean, cov, valid) derivation would otherwise run as
        ~15 eager ops per candidate, each a separate dispatch.
        Returns (refined pose, CS divergence, root^-1 * query) in one fetch.
        """
        guess = compose(
            compose(inverse(root_pose), match_pose),
            jnp.stack([jnp.zeros_like(yaw), jnp.zeros_like(yaw), -yaw]))
        stats = C.CellStats(n=n_t[sub], s=s_t[sub], ss=ss_t[sub])
        cc = cfg.ndt_map.cell
        f_mean, f_cov = C.mean_cov(stats, cc.eig_floor_ratio,
                                   cc.intensity_var_jitter,
                                   use_pndt=cc.use_pndt)
        f_valid = C.valid_mask(stats, cfg.ndt_map.min_points_per_cell)
        est = matcher.estimate_loop(cfg, guess, f_mean, f_cov, f_valid,
                                    m_mean, m_cov, m_valid)
        mm2, mc2 = matcher.transform_mean_cov(est.pose, m_mean, m_cov)
        cs = D.cs_divergence(f_mean, f_cov, f_valid, mm2, mc2, m_valid)
        rel_odom = compose(inverse(root_pose), q_pose)
        return est.pose, cs, rel_odom

    def _node_features(self, frame):
        scan, filt = F.build_scan_cells(self.cfg, frame, self.s2b)
        desc = SC.make_descriptor(
            filt.polar, filt.points[:, 2], filt.mask, self.cfg.scan_context
        )
        return scan, desc, filt.beams, filt.beam_mask

    def _record_outputs(self, frame, out, nodes, edges):
        for k in range(2):
            if not nodes.valid[k]:
                continue
            nid = int(nodes.node_id[k])
            assert nid == len(self.node_pose)
            self.node_pose.append(nodes.pose[k])
            self.node_stamp.append(float(nodes.stamp[k]))
            self.node_traversed.append(float(nodes.traversed[k]))
            self.node_submap.append(int(nodes.submap_id[k]))
            self.node_frame.append(int(nodes.frame_idx[k]))
            self.node_is_root.append(bool(nodes.is_root[k]))
            # ScanContext insert (``makeAndSaveScancontextAndKeys``).  Nodes
            # are emitted ``insertion_delay`` frames late, so pull the node's
            # own frame from the history buffer.  The buffer horizon is sized
            # from the queue capacity (see ``process_frame``), so a miss is a
            # real bug — fail loudly instead of silently corrupting the loop
            # database with the wrong frame's descriptor.
            src = int(nodes.frame_idx[k])
            feats = self._recent_feats.get(src)
            if feats is not None:
                desc, cells, beams, beam_mask = feats
            elif src in self._recent_frames:
                # resume fallback: frames restored from a checkpoint predate
                # the per-frame feature harvest — recompute once
                fr = self._recent_frames[src]
                scan, desc, beams, beam_mask = self._features(fr)
                cells = (scan.mean, scan.cov, scan.valid)
            else:
                raise RuntimeError(
                    f"keyframe node {nid}'s source frame {src} aged out of "
                    f"the {len(self._recent_frames)}-frame history buffer "
                    f"(current frame {int(frame.index)}); horizon sizing bug")
            self.sc_desc.append(np.asarray(desc))
            self.sc_keys.append(np.asarray(SC.ring_key(desc)))
            if nid < self._sc_desc.shape[0]:
                self._sc_desc = self._sc_desc.at[nid].set(desc)
                self._sc_key = self._sc_key.at[nid].set(
                    jnp.asarray(self.sc_keys[-1]))
                self._sc_pos = self._sc_pos.at[nid].set(
                    jnp.asarray(nodes.pose[k][:2]))
                self._sc_trav = self._sc_trav.at[nid].set(
                    float(nodes.traversed[k]))
            self._node_cells[nid] = cells
            if not bool(nodes.is_root[k]):
                self._pending_loop_queries.append(nid)
            # Online raytracing cadence: the reference enqueues the node's
            # max-intensity beams at keyframe exit (``local_fuser.cpp:181-188``)
            # and a 20 Hz timer drains them into the submap counting grid
            # (``ndt_slam.cpp:366-368``); here the drain is synchronous.
            if self.cfg.visualize_ogm:
                self._raytrace_node(int(nodes.submap_id[k]), nodes.pose[k],
                                    np.asarray(beams), np.asarray(beam_mask))
        for k in range(2):
            if edges.valid[k]:
                self.edges.append((
                    int(edges.id_begin[k]), int(edges.id_end[k]),
                    edges.trans[k], edges.sqrt_information[k],
                ))

    def _raytrace_node(self, submap_id: int, node_pose, beams, beam_mask):
        """Bresenham the node's beams into its submap counting grid at the
        submap-local sensor pose (``HierarchicalMap::raytraceLine``)."""
        from ..io import native as NT

        o = self.cfg.ogm
        grid = self._count_grids.get(submap_id)
        if grid is None:
            grid = np.zeros((o.submap_size_y, o.submap_size_x), np.int32)
        # Submap-local pose from the CURRENT graph state (root and node move
        # together under PGO, so their relative pose stays consistent).
        root = int(np.asarray(self.carry.store_root)[
            min(submap_id, self.cfg.capacity.max_submaps - 1)])
        origin = (self.node_pose[root] if root < len(self.node_pose)
                  else np.asarray(self.carry.store_origin)[submap_id])
        local = np.asarray(compose(inverse(jnp.asarray(origin)),
                                   jnp.asarray(node_pose)))
        sensor = np.asarray(compose(jnp.asarray(local), self.s2b))
        A = beams.shape[0]
        poses_b = np.repeat(sensor[None, :], A, axis=0).astype(np.float32)
        self._count_grids[submap_id] = NT.bresenham_raytrace(
            grid, poses_b, beams[:, 0].astype(np.float32),
            beams[:, 1].astype(np.float32), beam_mask.astype(np.uint8),
            o.resolution,
        )

    def render_ogm(self) -> np.ndarray:
        """Fuse the per-submap counting grids at the CURRENT (post-PGO)
        submap origins into the global occupancy grid
        (``MasterMap::getOGM`` / ``visualizeMap`` cadence)."""
        from ..io import native as NT
        from ..mapping import ogm as OGM

        o = self.cfg.ogm
        if not self._count_grids:
            return np.full((o.size_y, o.size_x), 0.5, np.float32)
        subs = sorted(self._count_grids)
        grids = np.stack([self._count_grids[s] for s in subs])
        roots = np.asarray(self.carry.store_root)
        origins = []
        for s in subs:
            r = int(roots[min(s, self.cfg.capacity.max_submaps - 1)])
            origins.append(self.node_pose[r] if r < len(self.node_pose)
                           else np.asarray(self.carry.store_origin)[s])
        origins = jnp.asarray(np.stack(origins), jnp.float32)
        corner = jnp.asarray([-0.5 * o.submap_size_x * o.resolution,
                              -0.5 * o.submap_size_y * o.resolution, 0.0])
        sub_corners = compose(origins, jnp.broadcast_to(corner,
                                                        origins.shape))
        g_corner = jnp.asarray([-0.5 * o.size_x * o.resolution,
                                -0.5 * o.size_y * o.resolution, 0.0])
        if NT.have_native():
            rel = compose(jnp.broadcast_to(inverse(g_corner),
                                           sub_corners.shape), sub_corners)
            total = jnp.asarray(NT.fuse_counting_grids(
                grids, np.asarray(rel), o.resolution, o.resolution,
                o.size_y, o.size_x))
        else:
            total = OGM.fuse_submaps(
                jnp.asarray(grids, jnp.float32), sub_corners, o.resolution,
                o.resolution, g_corner, o.size_y, o.size_x)
        return np.asarray(OGM.global_occupancy(total))

    # -- public API ------------------------------------------------------------

    def process_frame(self, frame) -> np.ndarray:
        """One radar frame; returns the current global pose (/ndt_odom)."""
        self._recent_frames[int(frame.index)] = frame
        # Horizon: a keyframe queued at frame t exits at the earliest
        # ``insertion_delay`` frames later, and can back up behind up to
        # ``keyframe_queue`` earlier entries spaced ``insertion_step`` apart.
        lf = self.cfg.local_fuser
        horizon = (lf.insertion_delay
                   + lf.insertion_step * self.cfg.capacity.keyframe_queue + 2)
        for k in list(self._recent_frames):
            if k < int(frame.index) - horizon:
                del self._recent_frames[k]
        for k in list(self._recent_feats):
            if k < int(frame.index) - horizon:
                del self._recent_feats[k]
        t0 = _pc()
        self.carry, out = self._step(self.carry, frame)
        self._recent_feats[int(frame.index)] = (
            out.sc_desc, out.scan_cells, out.beams, out.beam_mask)
        # ONE bundled device->host fetch for everything the host graph logic
        # reads this frame (instead of ~15 per-field transfers)
        nodes, edges, odom_pose, rejected = jax.device_get(
            (out.nodes, out.edges, out.odom_pose, out.rejected))
        self.stage_walls["step"].append(_pc() - t0)
        t0 = _pc()
        self._record_outputs(frame, out, nodes, edges)
        self.odom_trace.append(odom_pose)
        self.rejected_trace.append(bool(rejected))
        self.stage_walls["record"].append(_pc() - t0)
        self._frame_count += 1
        if self._frame_count % self.loop_every == 0:
            t0 = _pc()
            self.detect_loops()
            self.stage_walls["loops"].append(_pc() - t0)
        if self._frame_count % self.pgo_every == 0:
            t0 = _pc()
            self.optimize_pose_graph()
            self.stage_walls["pgo"].append(_pc() - t0)
        return self.odom_trace[-1]

    def detect_loops(self):
        """``LocalFuser::detectLoopClosures`` over the pending keyframe queue."""
        cfg = self.cfg
        N = min(len(self.sc_desc), self._sc_desc.shape[0])
        if N == 0:
            self._pending_loop_queries.clear()
            return
        # database already lives on device — no per-cadence upload
        descs = self._sc_desc
        keys = self._sc_key
        positions = self._sc_pos
        dists = self._sc_trav
        store_root = None  # fetched once per cadence, only if needed
        for q in self._pending_loop_queries:
            if q >= N:  # beyond the padded capacity — cannot query
                continue
            # one bundled fetch of the retrieval result (match id + yaw)
            cand = jax.device_get(
                self._detect(jnp.int32(q), descs, keys, positions, dists,
                             jnp.int32(N)))
            m = int(cand.match_id)
            if m < 0 or self.node_submap[m] == self.node_submap[q]:
                continue
            sub = self.node_submap[m]
            if store_root is None:
                store_root = np.asarray(self.carry.store_root)
            root = int(store_root[sub])
            m_mean, m_cov, m_valid = self._node_cells[q]
            # guess composition + store-row gather + (mean, cov, valid)
            # derivation + GNC refine + CS gate: ONE dispatch, ONE fetch
            pose, cs, rel_odom = jax.device_get(self._refine(
                jnp.int32(sub), self.carry.store_cells.n,
                self.carry.store_cells.s, self.carry.store_cells.ss,
                jnp.asarray(self.node_pose[root], jnp.float32),
                jnp.asarray(self.node_pose[m], jnp.float32),
                jnp.float32(cand.yaw_rad),
                jnp.asarray(self.node_pose[q], jnp.float32),
                m_mean, m_cov, m_valid))
            from ..loops.detector import odom_consistency_gate

            span_m = np.asarray(
                [self.node_traversed[q] - self.node_traversed[root]])
            odom_ok = bool(odom_consistency_gate(
                cfg.local_fuser, np.asarray(pose)[None],
                np.asarray(rel_odom)[None], span_m)[0])
            if odom_ok and (float(cs)
                            < cfg.local_fuser.loop_closure_max_cs_divergence):
                sqrtI = cfg.local_fuser.loop_closure_weight * np.asarray(
                    cfg.local_fuser.loop_sqrt_information, np.float32)
                self.edges.append((root, q, np.asarray(pose), sqrtI))
                self.n_loop_edges += 1
        self._pending_loop_queries.clear()

    def finalize(self):
        """Bag-end semantics (``ndt_slam.cpp:176-178``): drain the pending
        loop queue, then one final PGO over EVERY edge (max_update_index =
        last node, matching ``std::prev(nodes_.end())->first``) + submap
        re-anchoring."""
        self.detect_loops()
        self.optimize_pose_graph(final=True)

    def optimize_pose_graph(self, final: bool = False):
        """``NDTSlam::optimizePoseGraph`` + ``LocalFuser::updateSubmaps``."""
        cfg = self.cfg
        N = len(self.node_pose)
        if N < 2 or not self.edges or self.n_loop_edges == 0:
            return
        lf = cfg.local_fuser
        n_per = int(np.ceil(
            (lf.submap_size_poses - (cfg.matcher.smoothing_steps - 1))
            / lf.insertion_step
        ))
        if final:
            max_update = N - 1
        else:
            max_update = (N - 1) // n_per * n_per  # ``ndt_slam.cpp:354-355``
        E = len(self.edges)
        # numpy graph: padding/filtering stay host-side, the jitted solve
        # uploads the padded buffers (no per-tick-shaped eager device ops)
        g = PG.PoseGraph(
            poses=np.stack(self.node_pose).astype(np.float32),
            id_begin=np.asarray([e[0] for e in self.edges], np.int32),
            id_end=np.asarray([e[1] for e in self.edges], np.int32),
            trans=np.stack([np.asarray(e[2]) for e in self.edges]).astype(
                np.float32),
            sqrt_information=np.stack(
                [np.asarray(e[3]) for e in self.edges]).astype(np.float32),
            valid=np.ones(E, bool),
        )
        # Size-routed (``schur.optimize_auto``): dense normal equations while
        # the graph is small, submap-sharded Schur complement beyond (online
        # full-sequence Oxford graphs reach ~4k nodes).  Kernel caching makes the per-tick cost ~iterations x device time.
        from ..graph import schur

        poses, _ = schur.optimize_auto(
            g, cfg.global_fuser,
            node_submap=np.asarray(self.node_submap),
            node_is_root=np.asarray(self.node_is_root),
            max_update_index=max_update)
        poses = np.asarray(poses)
        for i in range(N):
            self.node_pose[i] = poses[i]
        # Re-anchor: the ACTIVE submap origin moves to its root node's
        # optimized pose and the last emitted node is refreshed, steering
        # subsequent odometry/edges (``updateSubmaps``, ``local_fuser.cpp:65-88``).
        cur_sub = int(self.carry.n_finished)
        root = int(np.asarray(self.carry.store_root)[
            min(cur_sub, self.cfg.capacity.max_submaps - 1)])
        if root < N:
            self.carry = self.carry._replace(
                submap_origin=jnp.asarray(poses[root], jnp.float32),
                last_node_pose=jnp.asarray(poses[N - 1], jnp.float32),
            )

    def trajectory(self):
        return np.stack(self.node_pose) if self.node_pose else np.zeros((0, 3))

    # -- checkpoint / resume ---------------------------------------------------
    # The reference has no persistence (SURVEY.md §5); long online runs need
    # it.  The device carry snapshots via utils/checkpoint; the host-side
    # graph / ScanContext / queue state (the reference's nodes_/edges_ and
    # SCManager members) is captured here so a resumed engine reproduces the
    # uninterrupted run bit-for-bit.

    def save_checkpoint(self, path: str):
        from ..utils import checkpoint as CK

        flat = CK._flatten(self.carry, "carry/")
        N = len(self.node_pose)
        host = {
            "node_pose": (np.stack(self.node_pose) if N
                          else np.zeros((0, 3), np.float32)),
            "node_stamp": np.asarray(self.node_stamp, np.float64),
            "node_traversed": np.asarray(self.node_traversed, np.float64),
            "node_submap": np.asarray(self.node_submap, np.int64),
            "node_frame": np.asarray(self.node_frame, np.int64),
            "node_is_root": np.asarray(self.node_is_root, bool),
            "edge_begin": np.asarray([e[0] for e in self.edges], np.int64),
            "edge_end": np.asarray([e[1] for e in self.edges], np.int64),
            "edge_trans": (np.stack([np.asarray(e[2]) for e in self.edges])
                           if self.edges else np.zeros((0, 3), np.float32)),
            "edge_sqrtI": (np.stack([np.asarray(e[3]) for e in self.edges])
                           if self.edges else np.zeros((0, 3, 3), np.float32)),
            "n_loop_edges": np.int64(self.n_loop_edges),
            "frame_count": np.int64(self._frame_count),
            "pending": np.asarray(self._pending_loop_queries, np.int64),
            "odom_trace": (np.stack(self.odom_trace) if self.odom_trace
                           else np.zeros((0, 3), np.float32)),
            "sc_desc": self._sc_desc[:N],
            "sc_key": self._sc_key[:N],
            "sc_pos": self._sc_pos[:N],
            "sc_trav": self._sc_trav[:N],
        }
        # per-node scan cells (loop refinement inputs)
        ids = sorted(self._node_cells)
        host["cells_ids"] = np.asarray(ids, np.int64)
        if ids:
            host["cells_mean"] = np.stack(
                [np.asarray(self._node_cells[i][0]) for i in ids])
            host["cells_cov"] = np.stack(
                [np.asarray(self._node_cells[i][1]) for i in ids])
            host["cells_valid"] = np.stack(
                [np.asarray(self._node_cells[i][2]) for i in ids])
        # OGM counting grids
        subs = sorted(self._count_grids)
        host["ogm_ids"] = np.asarray(subs, np.int64)
        if subs:
            host["ogm_grids"] = np.stack([self._count_grids[s] for s in subs])
        # recent-frame buffer (pending keyframe descriptors after resume)
        fids = sorted(self._recent_frames)
        host["recent_ids"] = np.asarray(fids, np.int64)
        if fids:
            frames = [self._recent_frames[i] for i in fids]
            for field in frames[0]._fields:
                host[f"recent/{field}"] = np.stack(
                    [np.asarray(getattr(fr, field)) for fr in frames])
        np.savez_compressed(path, **flat, **{f"host/{k}": v
                                             for k, v in host.items()})

    def load_checkpoint(self, path: str):
        import jax.numpy as jnp

        from ..utils import checkpoint as CK

        data = np.load(path)

        def rebuild(node, prefix):
            if hasattr(node, "_asdict") and hasattr(node, "_replace"):
                return type(node)(**{
                    k: rebuild(v, f"{prefix}{k}/")
                    for k, v in node._asdict().items()})
            key = prefix.rstrip("/")
            if key not in data.files:
                return node  # checkpoint predates this carry field
            return jnp.asarray(data[key])

        self.carry = rebuild(self.carry, "carry/")
        if "carry/submap_fmean" not in data.files:
            # Checkpoint predates the derived-field caches: rebuild them from
            # the loaded submaps (template zeros would degrade the next 1-2
            # registrations until the keyframe-exit refresh).  Checkpoints
            # that DO carry them are trusted verbatim — recomputing here
            # fuses differently than the in-step derivation and would break
            # bit-exact resume reproduction.
            from ..ndt import grid as G

            mp = self.cfg.ndt_map.min_points_per_cell
            cc = self.cfg.ndt_map.cell
            sf = G.derive_sparse_fields(self.carry.submap, mp, cc)
            pf = G.derive_sparse_fields(self.carry.prev_submap, mp, cc)
            self.carry = self.carry._replace(
                submap_fmean=sf[0], submap_fcov=sf[1], submap_fvalid=sf[2],
                prev_fmean=pf[0], prev_fcov=pf[1], prev_fvalid=pf[2])
        h = lambda k: data[f"host/{k}"]
        self.node_pose = [p for p in h("node_pose")]
        self.node_stamp = list(h("node_stamp"))
        self.node_traversed = list(h("node_traversed"))
        self.node_submap = [int(v) for v in h("node_submap")]
        self.node_frame = [int(v) for v in h("node_frame")]
        self.node_is_root = [bool(v) for v in h("node_is_root")]
        self.edges = [
            (int(b), int(e), t, s) for b, e, t, s in zip(
                h("edge_begin"), h("edge_end"), h("edge_trans"),
                h("edge_sqrtI"))]
        self.n_loop_edges = int(h("n_loop_edges"))
        self._frame_count = int(h("frame_count"))
        self._pending_loop_queries = [int(v) for v in h("pending")]
        self.odom_trace = [p for p in h("odom_trace")]
        N = len(self.node_pose)
        self._sc_desc = self._sc_desc.at[:N].set(jnp.asarray(h("sc_desc")))
        self._sc_key = self._sc_key.at[:N].set(jnp.asarray(h("sc_key")))
        self._sc_pos = self._sc_pos.at[:N].set(jnp.asarray(h("sc_pos")))
        self._sc_trav = self._sc_trav.at[:N].set(jnp.asarray(h("sc_trav")))
        self.sc_desc = [d for d in h("sc_desc")]
        self.sc_keys = [k for k in h("sc_key")]
        self._node_cells = {}
        ids = [int(v) for v in h("cells_ids")]
        if ids:
            for j, i in enumerate(ids):
                self._node_cells[i] = (
                    jnp.asarray(h("cells_mean")[j]),
                    jnp.asarray(h("cells_cov")[j]),
                    jnp.asarray(h("cells_valid")[j]))
        self._count_grids = {}
        subs = [int(v) for v in h("ogm_ids")]
        if subs:
            for j, s in enumerate(subs):
                self._count_grids[s] = h("ogm_grids")[j].copy()
        self._recent_frames = {}
        fids = [int(v) for v in h("recent_ids")]
        if fids:
            fields = {f: data[f"host/recent/{f}"] for f in F.Frame._fields}
            for j, i in enumerate(fids):
                self._recent_frames[i] = F.Frame(
                    **{f: jnp.asarray(fields[f][j]) for f in F.Frame._fields})
