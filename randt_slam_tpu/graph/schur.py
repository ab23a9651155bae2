"""Distributed pose-graph solve: submap-sharded Schur complement.

The reference solves its pose graph with single-process sparse Cholesky
(``global_fuser.cpp:52-59``).  This build exploits the SLAM graph's
structure instead: nodes group into submaps whose ROOT nodes are the only
ones loop edges attach to (``local_fuser.cpp:341-347``), and odometry chains
only cross submap boundaries at roots.  Ordering variables
[interiors | roots] therefore makes the interior block A of the normal
equations BLOCK-DIAGONAL BY SUBMAP:

    H = [[A, B], [B^T, C]],   A = diag(A_1 ... A_S)

so each Gauss-Newton step runs as
  1. per-submap assembly of (A_s, B_s, g_s)          — vmapped, sharded over
     the mesh's ``data`` axis (submaps are the shards).  B_s couples only to
     the submap's LOCAL separator set (its own root, the adjacent root, and
     the loop roots its interiors touch — L slots), so per-device FLOPs and
     memory are O(submaps/device · L), constant under weak scaling,
  2. per-submap damped Cholesky of A_s and the local Schur contributions
     B_s^T A_s^{-1} B_s, B_s^T A_s^{-1} g_s          — vmapped, sharded,
  3. scatter of the (3L, 3L) local blocks into the (3R, 3R) reduced system
     + ONE ``psum`` over the mesh (R = #roots = #submaps, tiny),
  4. replicated dense solve for the root increment,
  5. per-submap back-substitution of the interiors   — sharded.

Communication per iteration is ONE all-reduce of the reduced system — the
"Schur complement over submap-root separators" north star (SURVEY.md §7.1.7).

``optimize_distributed`` (edge-sharded assembly + replicated dense solve) is
kept as the small-graph path.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GlobalFuserConfig
from ..geometry import normalize_angle
from ..parallel.mesh import P, shard_map
from . import pose_graph as PG


# ---------------------------------------------------------------------------
# small-graph path: edge-sharded assembly, replicated dense solve
# ---------------------------------------------------------------------------


def _pad_edges(g: PG.PoseGraph, multiple: int) -> PG.PoseGraph:
    E = g.id_begin.shape[0]
    pad = (-E) % multiple
    if pad == 0:
        return g
    z3 = jnp.zeros((pad, 3), g.trans.dtype)
    return PG.PoseGraph(
        poses=g.poses,
        id_begin=jnp.concatenate([g.id_begin, jnp.zeros(pad, jnp.int32)]),
        id_end=jnp.concatenate([g.id_end, jnp.zeros(pad, jnp.int32)]),
        trans=jnp.concatenate([g.trans, z3]),
        sqrt_information=jnp.concatenate(
            [g.sqrt_information, jnp.zeros((pad, 3, 3), g.trans.dtype)]
        ),
        valid=jnp.concatenate([g.valid, jnp.zeros(pad, bool)]),
    )


def optimize_distributed(g: PG.PoseGraph, cfg: GlobalFuserConfig, mesh):
    """Gauss-Newton with the per-iteration assembly sharded over ``data``."""
    n_dev = mesh.devices.size
    g = _pad_edges(g, n_dev)
    N = g.poses.shape[0]
    dtype = g.poses.dtype
    fixed_mask = jnp.zeros(N, bool).at[0].set(True)
    free_f = (~jnp.repeat(fixed_mask, 3)).astype(dtype)

    edge_leaves = (g.id_begin, g.id_end, g.trans, g.sqrt_information, g.valid)

    def local_assemble(poses, id_begin, id_end, trans, sqrtI, valid):
        sub = PG.PoseGraph(
            poses=poses, id_begin=id_begin, id_end=id_end, trans=trans,
            sqrt_information=sqrtI, valid=valid,
        )
        H, grad, cost = PG._assemble(
            poses, sub, PG.robust_spec(cfg), cfg.loss_function_scale
        )
        H = jax.lax.psum(H, "data")
        grad = jax.lax.psum(grad, "data")
        cost = jax.lax.psum(cost, "data")
        return H, grad, cost

    assemble = shard_map(
        local_assemble,
        mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P("data"), P("data"), P("data")),
        out_specs=(P(), P(), P()),
    )

    def body(carry):
        poses, lam, cost_prev, it, done = carry
        H, grad, cost = assemble(poses, *edge_leaves)
        H = H * free_f[:, None] * free_f[None, :]
        grad = grad * free_f
        damp = lam * jnp.maximum(jnp.diag(H), 1e-8) + (1.0 - free_f)
        delta = -PG.spd_solve(H + jnp.diag(damp), grad) * free_f
        trial = poses + delta.reshape(N, 3)
        trial = trial.at[:, 2].set(normalize_angle(trial[:, 2]))
        _, _, cost_new = assemble(trial, *edge_leaves)
        accept = cost_new < cost
        poses_n = jnp.where(accept, trial, poses)
        lam_n = jnp.clip(jnp.where(accept, lam / 3.0, lam * 4.0), 1e-12, 1e8)
        small = jnp.linalg.norm(delta) < cfg.tolerance * (1.0 + jnp.linalg.norm(poses))
        done_n = (accept & small) | ((~accept) & (lam >= 1e7))
        return poses_n, lam_n, jnp.where(accept, cost_new, cost), it + 1, done_n

    def cond(carry):
        _, _, _, it, done = carry
        return (it < cfg.max_iterations) & (~done)

    init = (g.poses, jnp.asarray(1e-6, dtype), jnp.asarray(jnp.inf, dtype),
            jnp.int32(0), jnp.bool_(False))
    poses, _, cost, iters, _ = jax.lax.while_loop(cond, body, init)
    return poses, {"cost": cost, "iterations": iters}


# ---------------------------------------------------------------------------
# submap-sharded Schur-complement path
# ---------------------------------------------------------------------------


class SchurLayout(NamedTuple):
    """Host-built static partition of a SLAM pose graph for the Schur solve.

    S   = number of submaps (padded to the mesh size)
    I   = max interiors per submap
    Es  = max edges owned per submap (interior-interior + interior-root)
    R   = number of root (separator) nodes == number of real submaps
    """

    # node bookkeeping
    int_node: np.ndarray     # (S, I) global node id per interior slot, -1 pad
    int_valid: np.ndarray    # (S, I)
    root_node: np.ndarray    # (R,) global node id per separator index
    # per-submap owned edges; endpoints in LOCAL coordinates:
    #   kind 0: a = interior slot, b = interior slot
    #   kind 1: a = interior slot, b = LOCAL separator slot
    #   kind 2: a = LOCAL separator slot, b = interior slot
    edge_idx: np.ndarray     # (S, Es) global edge index, -1 pad
    edge_kind: np.ndarray    # (S, Es)
    edge_a: np.ndarray       # (S, Es) local slot of endpoint id_begin
    edge_b: np.ndarray       # (S, Es) local slot of endpoint id_end
    # separators each submap touches, local slot -> global separator index.
    # Keeps per-submap coupling blocks O(L) instead of O(R) so per-device
    # work stays constant under weak scaling.
    sep_ids: np.ndarray      # (S, L) global separator index, -1 pad
    # separator-separator edges (rare: 1-node submaps), handled replicated
    ss_idx: np.ndarray       # (Ess,) global edge index
    ss_a: np.ndarray         # (Ess,) separator index of id_begin
    ss_b: np.ndarray         # (Ess,)
    n_submaps: int


def _round_up(x: int, m: int) -> int:
    return max(m, -(-int(x) // m) * m)


def build_layout(node_submap, node_is_root, id_begin, id_end,
                 pad_submaps_to: int = 1,
                 bucket_interiors: int = 1, bucket_edges: int = 1,
                 bucket_seps: int = 1) -> SchurLayout:
    """Host-side static partition (numpy; runs once per graph shape).

    The ``bucket_*`` arguments round the padded dimensions (interiors I,
    owned edges Es, local separators L) up to multiples so that layouts of
    steadily-growing graphs share shape signatures — the per-signature jitted
    kernels (:func:`_get_kernels`) then hit their cache across PGO ticks
    instead of re-tracing (the reference pays Ceres problem-construction on
    every ``optimizePoseGraph`` tick; we pay XLA tracing once per bucket).
    """
    node_submap = np.asarray(node_submap)
    node_is_root = np.asarray(node_is_root, bool)
    id_begin = np.asarray(id_begin)
    id_end = np.asarray(id_end)
    R = int(node_is_root.sum())
    root_ids = np.nonzero(node_is_root)[0]
    root_node = np.zeros(R, np.int32)
    sep_of_node = np.full(len(node_submap), -1, np.int32)
    for s, nid in enumerate(root_ids):
        root_node[s] = nid
        sep_of_node[nid] = s
    S = max(R, 1)
    S_pad = -(-S // pad_submaps_to) * pad_submaps_to

    # interior slots per submap
    int_lists = [[] for _ in range(S)]
    int_slot = np.full(len(node_submap), -1, np.int32)
    for nid in range(len(node_submap)):
        if node_is_root[nid]:
            continue
        s = int(node_submap[nid])
        int_slot[nid] = len(int_lists[s])
        int_lists[s].append(nid)
    I = max(1, max((len(l) for l in int_lists), default=1))
    I = _round_up(I, bucket_interiors)
    int_node = np.full((S_pad, I), -1, np.int32)
    for s, l in enumerate(int_lists):
        int_node[s, :len(l)] = l

    # edge ownership; separator endpoints become LOCAL slots per submap
    owned = [[] for _ in range(S)]
    local_seps = [dict() for _ in range(S)]  # global sep -> local slot

    def local_sep(s, sep):
        d = local_seps[s]
        if sep not in d:
            d[sep] = len(d)
        return d[sep]

    ss = []
    for e in range(len(id_begin)):
        a, b = int(id_begin[e]), int(id_end[e])
        ra, rb = node_is_root[a], node_is_root[b]
        if ra and rb:
            ss.append((e, sep_of_node[a], sep_of_node[b]))
        elif ra:  # separator -> interior
            s = int(node_submap[b])
            owned[s].append((e, 2, local_sep(s, int(sep_of_node[a])),
                             int_slot[b]))
        elif rb:  # interior -> separator
            s = int(node_submap[a])
            owned[s].append((e, 1, int_slot[a],
                             local_sep(s, int(sep_of_node[b]))))
        else:
            sa, sb = int(node_submap[a]), int(node_submap[b])
            assert sa == sb, (
                f"edge {e} couples interiors of submaps {sa} and {sb}; "
                "the Schur layout requires interior blocks to be "
                "submap-diagonal")
            owned[sa].append((e, 0, int_slot[a], int_slot[b]))
    Es = _round_up(max(1, max((len(l) for l in owned), default=1)),
                   bucket_edges)
    L = _round_up(max(1, max((len(d) for d in local_seps), default=1)),
                  bucket_seps)
    edge_idx = np.full((S_pad, Es), -1, np.int32)
    edge_kind = np.zeros((S_pad, Es), np.int32)
    edge_a = np.zeros((S_pad, Es), np.int32)
    edge_b = np.zeros((S_pad, Es), np.int32)
    sep_ids = np.full((S_pad, L), -1, np.int32)
    for s, l in enumerate(owned):
        for j, (e, k, a, b) in enumerate(l):
            edge_idx[s, j] = e
            edge_kind[s, j] = k
            edge_a[s, j] = a
            edge_b[s, j] = b
    for s, d in enumerate(local_seps):
        for sep, slot in d.items():
            sep_ids[s, slot] = sep
    ss = np.asarray(ss, np.int64).reshape(-1, 3)
    return SchurLayout(
        int_node=int_node,
        int_valid=int_node >= 0,
        root_node=root_node,
        edge_idx=edge_idx, edge_kind=edge_kind,
        edge_a=edge_a, edge_b=edge_b,
        sep_ids=sep_ids,
        ss_idx=ss[:, 0].astype(np.int32),
        ss_a=ss[:, 1].astype(np.int32),
        ss_b=ss[:, 2].astype(np.int32),
        n_submaps=S,
    )


def _submap_blocks(poses, edges, lay, L: int,
                   robust, huber_scale):
    """Per-submap (vmappable) assembly of A_s, B_s (over the submap's LOCAL
    separator slots), g_int_s and the local cost.  lay fields are the
    per-submap rows of the SchurLayout; ``edges`` is the padded edge-leaf
    tuple (id_begin, id_end, trans, sqrt_information, valid)."""
    id_begin, id_end, trans, sqrtI_all, valid_all = edges
    eidx, ekind, ea, eb, int_valid = lay
    R = L  # separator endpoints are local slots of width L
    I = int_valid.shape[0]
    ok = eidx >= 0
    safe = jnp.where(ok, eidx, 0)
    sub = PG.PoseGraph(
        poses=poses,
        id_begin=id_begin[safe], id_end=id_end[safe],
        trans=trans[safe], sqrt_information=sqrtI_all[safe],
        valid=valid_all[safe] & ok,
    )
    r = PG.edge_residuals(poses, sub)
    Ja, Jb = PG._edge_jacobians(poses, sub)
    w = sub.valid.astype(poses.dtype)
    if robust is not None:
        w = w * PG.robust_weight(r, sub.id_begin, sub.id_end,
                                 huber_scale, robust)
    Wa = Ja * w[:, None, None]
    Wb = Jb * w[:, None, None]
    Haa = jnp.einsum("eij,eik->ejk", Wa, Ja)
    Hab = jnp.einsum("eij,eik->ejk", Wa, Jb)
    Hbb = jnp.einsum("eij,eik->ejk", Wb, Jb)
    ga = jnp.einsum("eij,ei->ej", Wa, r)
    gb = jnp.einsum("eij,ei->ej", Wb, r)
    cost = 0.5 * jnp.sum(w * jnp.sum(r * r, axis=-1))

    # scatter into (I, 3, I, 3), (I, 3, R, 3), (R, 3, R, 3 — root self terms)
    is_ii = ekind == 0
    is_is = ekind == 1   # a interior, b separator
    is_si = ekind == 2   # a separator, b interior
    ia_int = jnp.where(is_ii | is_is, ea, I)      # interior slot of endpoint a
    ib_int = jnp.where(is_ii, eb, jnp.where(is_si, eb, I))
    ia_sep = jnp.where(is_si, ea, R)              # separator index of a
    ib_sep = jnp.where(is_is, eb, R)

    A = jnp.zeros((I + 1, 3, I + 1, 3), poses.dtype)
    A = A.at[ia_int, :, ia_int, :].add(Haa)
    A = A.at[ib_int, :, ib_int, :].add(Hbb)
    A = A.at[ia_int, :, ib_int, :].add(jnp.where(is_ii[:, None, None], Hab, 0.0))
    A = A.at[ib_int, :, ia_int, :].add(
        jnp.where(is_ii[:, None, None], jnp.swapaxes(Hab, -1, -2), 0.0))
    A = A[:I, :, :I, :]

    B = jnp.zeros((I + 1, 3, R + 1, 3), poses.dtype)
    B = B.at[ia_int, :, ib_sep, :].add(jnp.where(is_is[:, None, None], Hab, 0.0))
    B = B.at[ib_int, :, ia_sep, :].add(
        jnp.where(is_si[:, None, None], jnp.swapaxes(Hab, -1, -2), 0.0))
    B = B[:I, :, :R, :]

    Csep = jnp.zeros((R + 1, 3, 3), poses.dtype)   # root diagonal terms
    Csep = Csep.at[ia_sep].add(jnp.where(is_si[:, None, None], Haa, 0.0))
    Csep = Csep.at[ib_sep].add(jnp.where(is_is[:, None, None], Hbb, 0.0))
    Csep = Csep[:R]

    g_int = jnp.zeros((I + 1, 3), poses.dtype)
    g_int = g_int.at[ia_int].add(jnp.where(is_ii[:, None] | is_is[:, None], ga, 0.0))
    g_int = g_int.at[ib_int].add(jnp.where(is_ii[:, None] | is_si[:, None], gb, 0.0))
    g_int = g_int[:I]

    g_sep = jnp.zeros((R + 1, 3), poses.dtype)
    g_sep = g_sep.at[ia_sep].add(jnp.where(is_si[:, None], ga, 0.0))
    g_sep = g_sep.at[ib_sep].add(jnp.where(is_is[:, None], gb, 0.0))
    g_sep = g_sep[:R]

    return A, B, Csep, g_int, g_sep, cost


def _ss_blocks(poses, edges, ss, R: int, robust, huber_scale, dtype):
    """Separator-separator edge contributions (replicated, tiny).

    ``ss = (idx, sa, sb, ss_valid)`` padded to a static length; invalid
    (padding) entries carry zero weight."""
    id_begin, id_end, trans, sqrtI_all, valid_all = edges
    idx, sa, sb, ss_valid = ss
    sub = PG.PoseGraph(
        poses=poses, id_begin=id_begin[idx], id_end=id_end[idx],
        trans=trans[idx], sqrt_information=sqrtI_all[idx],
        valid=valid_all[idx] & ss_valid,
    )
    r = PG.edge_residuals(poses, sub)
    Ja, Jb = PG._edge_jacobians(poses, sub)
    w = sub.valid.astype(dtype)
    if robust is not None:
        w = w * PG.robust_weight(r, sub.id_begin, sub.id_end,
                                 huber_scale, robust)
    Wa = Ja * w[:, None, None]
    Wb = Jb * w[:, None, None]
    C = jnp.zeros((R, 3, R, 3), dtype)
    C = C.at[sa, :, sa, :].add(jnp.einsum("eij,eik->ejk", Wa, Ja))
    C = C.at[sb, :, sb, :].add(jnp.einsum("eij,eik->ejk", Wb, Jb))
    Hab = jnp.einsum("eij,eik->ejk", Wa, Jb)
    C = C.at[sa, :, sb, :].add(Hab)
    C = C.at[sb, :, sa, :].add(jnp.swapaxes(Hab, -1, -2))
    gs = jnp.zeros((R, 3), dtype)
    gs = gs.at[sa].add(jnp.einsum("eij,ei->ej", Wa, r))
    gs = gs.at[sb].add(jnp.einsum("eij,ei->ej", Wb, r))
    cost = 0.5 * jnp.sum(w * jnp.sum(r * r, axis=-1))
    return C.reshape(3 * R, 3 * R), gs.reshape(3 * R), cost


def _mesh_key(mesh):
    if mesh is None:
        return None
    return (tuple(mesh.axis_names), mesh.devices.shape,
            tuple(d.id for d in mesh.devices.flat))


# jitted kernels keyed by (shape signature, loss flag, dtype, mesh) — a PGO
# tick on a bucketed layout re-traces NOTHING (per-call closures would pay
# host/trace overhead far above the device work)
_KERNEL_CACHE: dict = {}
_LAYOUT_CACHE: dict = {}
_LAYOUT_CACHE_MAX = 8


def _layout_cached(node_submap, node_is_root, id_begin, id_end,
                   n_dev: int) -> "SchurLayout":
    """Content-addressed cache of :func:`build_layout` (bucketed dims)."""
    ns = np.ascontiguousarray(np.asarray(node_submap, np.int32))
    nr = np.ascontiguousarray(np.asarray(node_is_root, bool))
    ib = np.ascontiguousarray(np.asarray(id_begin, np.int32))
    ie = np.ascontiguousarray(np.asarray(id_end, np.int32))
    key = (ns.tobytes(), nr.tobytes(), ib.tobytes(), ie.tobytes(), n_dev)
    if key not in _LAYOUT_CACHE:
        if len(_LAYOUT_CACHE) >= _LAYOUT_CACHE_MAX:
            _LAYOUT_CACHE.pop(next(iter(_LAYOUT_CACHE)))
        _LAYOUT_CACHE[key] = build_layout(
            ns, nr, ib, ie,
            pad_submaps_to=max(n_dev, 1),
            bucket_interiors=8, bucket_edges=16, bucket_seps=4)
    return _LAYOUT_CACHE[key]


def _make_kernels(N, E, S, I, Es, L, Ess, R, use_h, dtype, mesh):
    """Jitted per-iteration kernels for one shape signature.  All graph and
    layout data arrive as runtime arguments, so kernels are reusable across
    PGO ticks whose padded shapes match."""

    def submap_pass(poses, edges, lay_rows, lam, scale):
        """Per-submap Schur contributions (vmapped; runs inside shard_map).

        Returns COMPACT per-submap blocks — (Sv, 3L, 3L) reduced-system
        contribution + (Sv, 3L) gradient — NOT the dense (3R, 3R) scatter:
        what crosses the mesh is then only the touched separator blocks
, an O(S L^2) payload instead of O(R^2)."""
        A, B, Csep, g_int, g_sep, cost = jax.vmap(
            lambda rows: _submap_blocks(poses, edges, rows, L, use_h, scale)
        )(lay_rows)
        Sv, Iv = A.shape[0], A.shape[1]
        free = jnp.repeat(lay_rows[4].astype(dtype), 3, axis=-1)  # (Sv, 3I)
        Af = A.reshape(Sv, 3 * Iv, 3 * Iv)
        Af = Af * free[:, :, None] * free[:, None, :]
        damp = lam * jnp.maximum(
            jnp.diagonal(Af, axis1=1, axis2=2), 1e-8) + (1.0 - free)
        Af = Af + jax.vmap(jnp.diag)(damp)
        Bf = B.reshape(Sv, 3 * Iv, 3 * L) * free[:, :, None]
        gf = g_int.reshape(Sv, 3 * Iv) * free

        chol = jax.vmap(jnp.linalg.cholesky)(Af)
        AinvB = jax.vmap(jax.scipy.linalg.cho_solve, in_axes=((0, None), 0))(
            (chol, True), Bf)
        Ainvg = jax.vmap(jax.scipy.linalg.cho_solve, in_axes=((0, None), 0))(
            (chol, True), gf[..., None])[..., 0]

        # compact local contribution: -B^T A^-1 B plus the per-slot (3, 3)
        # root diagonal terms from owned IS/SI edges on the block diagonal
        Cblk = -jnp.einsum("sab,sac->sbc", Bf, AinvB)      # (Sv, 3L, 3L)
        Cs = Csep.reshape(Sv, L, 3, 3)
        sl3 = jnp.arange(3 * L).reshape(L, 3)
        Cblk = Cblk.at[:, sl3[:, :, None], sl3[:, None, :]].add(Cs)
        g_loc = g_sep.reshape(Sv, 3 * L) - jnp.einsum("sab,sa->sb", Bf, Ainvg)
        return Cblk, g_loc, jnp.sum(cost), (chol, Bf, gf)

    def scatter_reduced(Cblk, g_loc, dof_rows):
        """Scatter compact blocks into the dense reduced system (replicated,
        cheap).  dof_rows: (S, 3L) with 3R as the dump slot for padding."""
        C_red = jnp.zeros((3 * R + 1, 3 * R + 1), dtype)
        C_red = C_red.at[dof_rows[:, :, None], dof_rows[:, None, :]].add(Cblk)
        g_red = jnp.zeros((3 * R + 1,), dtype).at[dof_rows].add(g_loc)
        return C_red[:3 * R, :3 * R], g_red[:3 * R]

    def reduced_system(poses, edges, lay_rows, dof_rows, ss, lam, scale):
        if mesh is None:
            Cblk, g_loc, cost, fact = submap_pass(poses, edges, lay_rows,
                                                  lam, scale)
            C_red, g_red = scatter_reduced(Cblk, g_loc, dof_rows)
        else:
            def local(poses, lam, scale, dof_rows, edges, rows):
                Cblk, g_loc, cost, fact = submap_pass(poses, edges, rows,
                                                      lam, scale)
                # all-gather ONLY the touched separator blocks: per-device
                # traffic is S*(9L^2+3L)*4 bytes instead of the former dense
                # (3R)^2 psum — >=2x smaller at acceptance scale and growing
                # linearly (not quadratically) with submap count.  The dense
                # scatter is then replicated, O(R^2) adds of local data.
                Cg = jax.lax.all_gather(Cblk, "data", tiled=True)
                gg = jax.lax.all_gather(g_loc, "data", tiled=True)
                C_red, g_red = scatter_reduced(Cg, gg, dof_rows)
                return (C_red, g_red, jax.lax.psum(cost, "data"), fact)
            C_red, g_red, cost, fact = shard_map(
                local, mesh=mesh,
                in_specs=(P(), P(), P(), P(),
                          (P(), P(), P(), P(), P()),
                          (P("data"), P("data"), P("data"), P("data"),
                           P("data"))),
                out_specs=(P(), P(), P(), (P("data"), P("data"), P("data"))),
            )(poses, lam, scale, dof_rows, edges, lay_rows)
        if Ess:
            Css, gss, css = _ss_blocks(poses, edges, ss, R, use_h, scale,
                                       dtype)
            return C_red + Css, g_red + gss, cost + css, fact
        return C_red, g_red, cost, fact

    def back_substitute(fact, dof_rows, dsep):
        chol, Bf, gf = fact

        def local_back(chol, Bf, gf, dof_rows, dsep):
            dsep_pad = jnp.concatenate([dsep, jnp.zeros(1, dtype)])
            dsep_loc = dsep_pad[dof_rows]          # (Sv, 3L)
            rhs = gf + jnp.einsum("sab,sb->sa", Bf, dsep_loc)
            d = jax.vmap(jax.scipy.linalg.cho_solve, in_axes=((0, None), 0))(
                (chol, True), rhs[..., None])[..., 0]
            return -d

        if mesh is None:
            return local_back(chol, Bf, gf, dof_rows, dsep)
        return shard_map(
            local_back, mesh=mesh,
            in_specs=(P("data"), P("data"), P("data"), P("data"), P()),
            out_specs=P("data"),
        )(chol, Bf, gf, dof_rows, dsep)

    def total_cost(poses, edges, scale):
        id_begin, id_end, trans, sqrtI_all, valid_all = edges
        sub = PG.PoseGraph(poses=poses, id_begin=id_begin, id_end=id_end,
                           trans=trans, sqrt_information=sqrtI_all,
                           valid=valid_all)
        r = PG.edge_residuals(poses, sub)
        w = valid_all.astype(dtype)
        if use_h is not None:
            w = w * PG.robust_weight(r, id_begin, id_end, scale, use_h)
        return 0.5 * jnp.sum(w * jnp.sum(r * r, axis=-1))

    def solve_sep(C_red, g_red, sep_free, lam):
        Cf = C_red * sep_free[:, None] * sep_free[None, :]
        damp = lam * jnp.maximum(jnp.diag(Cf), 1e-8) + (1.0 - sep_free)
        dsep = -PG.spd_solve(Cf + jnp.diag(damp), g_red * sep_free)
        return dsep * sep_free

    def apply_delta(poses, dsep, dint, root_node, int_node_safe, int_valid,
                    sep_free):
        new = poses
        dsep2 = (dsep * sep_free).reshape(R, 3)
        new = new.at[root_node].add(dsep2)
        upd = (dint.reshape(-1, I, 3) * int_valid[..., None]).reshape(-1, 3)
        new = new.at[int_node_safe.reshape(-1)].add(
            jnp.where(int_valid.reshape(-1)[:, None], upd, 0.0))
        return new.at[:, 2].set(normalize_angle(new[:, 2]))

    def optimize_loop(poses, edges, lay_rows, dof_rows, ss, sep_free,
                      root_node, int_node_safe, int_valid, scale,
                      max_iters, tol):
        """Full LM loop on device (``lax.while_loop``): ONE dispatch per
        solve — per-iteration host round-trips of a Python loop would
        dominate the wall time."""

        def body(carry):
            poses, lam, cost, it, done = carry
            C_red, g_red, _, fact = reduced_system(
                poses, edges, lay_rows, dof_rows, ss, lam, scale)
            dsep = solve_sep(C_red, g_red, sep_free, lam)
            dint = back_substitute(fact, dof_rows, dsep)
            trial = apply_delta(poses, dsep, dint, root_node, int_node_safe,
                                int_valid, sep_free)
            cost_new = total_cost(trial, edges, scale)
            accept = cost_new < cost
            poses_n = jnp.where(accept, trial, poses)
            lam_n = jnp.clip(jnp.where(accept, lam / 3.0, lam * 4.0),
                             1e-12, 1e8)
            step = jnp.linalg.norm(dsep) + jnp.linalg.norm(dint.reshape(-1))
            small = step < tol * (1.0 + jnp.linalg.norm(poses))
            done_n = (accept & small) | ((~accept) & (lam >= 1e7))
            return (poses_n, lam_n, jnp.where(accept, cost_new, cost),
                    it + 1, done_n)

        def cond(carry):
            _, _, _, it, done = carry
            return (it < max_iters) & (~done)

        init = (poses, jnp.asarray(1e-6, dtype),
                total_cost(poses, edges, scale), jnp.int32(0),
                jnp.bool_(False))
        poses, _, cost, iters, _ = jax.lax.while_loop(cond, body, init)
        return poses, cost, iters

    return {
        "reduced_system": jax.jit(reduced_system),
        "back_substitute": jax.jit(back_substitute),
        "total_cost": jax.jit(total_cost),
        "solve_sep": jax.jit(solve_sep),
        "apply_delta": jax.jit(apply_delta),
        "optimize_loop": jax.jit(optimize_loop),
    }


def _get_kernels(N, E, S, I, Es, L, Ess, R, use_h, dtype, mesh):
    key = (N, E, S, I, Es, L, Ess, R, use_h, np.dtype(dtype).name,
           _mesh_key(mesh))
    if key not in _KERNEL_CACHE:
        _KERNEL_CACHE[key] = _make_kernels(N, E, S, I, Es, L, Ess, R,
                                           use_h, dtype, mesh)
    return _KERNEL_CACHE[key]


class _SchurProblem(NamedTuple):
    """Padded device-resident state for one solve (shapes match a kernel
    signature in ``_KERNEL_CACHE``)."""

    kernels: dict
    poses: jax.Array          # (N_pad, 3)
    edges: tuple              # 5 padded edge leaves
    lay_rows: tuple           # 5 per-submap layout leaves
    dof_rows: jax.Array       # (S_pad, 3L)
    ss: tuple                 # (idx, sa, sb, valid) padded
    sep_free: jax.Array       # (3 R_pad,)
    root_node: jax.Array      # (R_pad,)
    int_node_safe: jax.Array
    int_valid: jax.Array
    scale: jax.Array
    n_nodes: int              # real node count


def _prepare(g: PG.PoseGraph, cfg: GlobalFuserConfig, node_submap,
             node_is_root, mesh) -> _SchurProblem:
    n_dev = mesh.devices.size if mesh is not None else 1
    lay = _layout_cached(node_submap, node_is_root, g.id_begin, g.id_end,
                         n_dev)
    dtype = g.poses.dtype
    N = g.poses.shape[0]
    N_pad = _round_up(N, 256)
    E = g.id_begin.shape[0]
    E_pad = _round_up(E, 256)
    R = len(lay.root_node)
    R_pad = _round_up(R, 8)
    Ess = len(lay.ss_idx)
    Ess_pad = _round_up(Ess, 8) if Ess else 0
    S_pad, I = lay.int_node.shape
    Es = lay.edge_idx.shape[1]
    L = lay.sep_ids.shape[1]

    poses = jnp.concatenate(
        [g.poses, jnp.zeros((N_pad - N, 3), dtype)]) if N_pad > N else g.poses
    pad_e = E_pad - E
    edges = (
        jnp.concatenate([g.id_begin, jnp.zeros(pad_e, jnp.int32)]),
        jnp.concatenate([g.id_end, jnp.zeros(pad_e, jnp.int32)]),
        jnp.concatenate([g.trans, jnp.zeros((pad_e, 3), dtype)]),
        jnp.concatenate([g.sqrt_information, jnp.zeros((pad_e, 3, 3), dtype)]),
        jnp.concatenate([g.valid, jnp.zeros(pad_e, bool)]),
    ) if pad_e else (g.id_begin, g.id_end, g.trans, g.sqrt_information,
                     g.valid)

    int_node = np.asarray(lay.int_node)
    lay_rows = (jnp.asarray(lay.edge_idx), jnp.asarray(lay.edge_kind),
                jnp.asarray(lay.edge_a), jnp.asarray(lay.edge_b),
                jnp.asarray(lay.int_valid))
    # per-submap separator DOF map: (S, 3L) reduced-system index; padded
    # slots -> 3 R_pad (dump row/col sliced off by the kernel)
    sep_ids = np.asarray(lay.sep_ids)
    dof = np.where(sep_ids[:, :, None] >= 0,
                   sep_ids[:, :, None] * 3 + np.arange(3)[None, None, :],
                   3 * R_pad).reshape(sep_ids.shape[0], 3 * L)
    dof_rows = jnp.asarray(dof, jnp.int32)
    if Ess:
        p = Ess_pad - Ess
        ss = (jnp.asarray(np.concatenate([lay.ss_idx, np.zeros(p, np.int32)])),
              jnp.asarray(np.concatenate([lay.ss_a, np.zeros(p, np.int32)])),
              jnp.asarray(np.concatenate([lay.ss_b, np.zeros(p, np.int32)])),
              jnp.asarray(np.concatenate([np.ones(Ess, bool),
                                          np.zeros(p, bool)])))
    else:
        z = jnp.zeros(0, jnp.int32)
        ss = (z, z, z, jnp.zeros(0, bool))
    # gauge: first root fixed; padded separator slots fixed too
    sep_free_np = np.ones((R_pad, 3), np.float32)
    sep_free_np[0] = 0.0
    sep_free_np[R:] = 0.0
    sep_free = jnp.asarray(sep_free_np.reshape(-1), dtype)
    root_node = jnp.asarray(np.concatenate(
        [lay.root_node, np.zeros(R_pad - R, np.int32)]))
    int_node_safe = jnp.asarray(np.where(int_node >= 0, int_node, 0))
    int_valid = jnp.asarray(lay.int_valid)

    kernels = _get_kernels(N_pad, E_pad, S_pad, I, Es, L, Ess_pad, R_pad,
                           PG.robust_spec(cfg), dtype, mesh)
    return _SchurProblem(
        kernels=kernels, poses=poses, edges=edges, lay_rows=lay_rows,
        dof_rows=dof_rows, ss=ss, sep_free=sep_free, root_node=root_node,
        int_node_safe=int_node_safe, int_valid=int_valid,
        scale=jnp.asarray(cfg.loss_function_scale, dtype), n_nodes=N,
    )


def optimize_schur(g: PG.PoseGraph, cfg: GlobalFuserConfig,
                   node_submap, node_is_root, mesh=None):
    """Gauss-Newton via the submap-sharded Schur complement.

    mesh=None runs the identical math single-device (vmapped over submaps);
    with a mesh, the submap axis is sharded over ``data`` and the reduced
    system is psum-reduced.  Gauge: the first ROOT is fixed.

    Kernels are cached by bucketed shape signature (node/edge counts rounded
    to 256, submaps to 8x mesh, separators to 8): successive PGO ticks on a
    growing graph reuse the compiled executables, so a tick costs
    ~iterations x device time instead of re-tracing.
    """
    dtype = g.poses.dtype
    pb = _prepare(g, cfg, node_submap, node_is_root, mesh)
    K = pb.kernels
    poses, cost, iters = K["optimize_loop"](
        pb.poses, pb.edges, pb.lay_rows, pb.dof_rows, pb.ss, pb.sep_free,
        pb.root_node, pb.int_node_safe, pb.int_valid, pb.scale,
        jnp.int32(cfg.max_iterations), jnp.asarray(cfg.tolerance, dtype))
    return poses[:pb.n_nodes], {"cost": cost, "iterations": int(iters)}


def optimize_auto(g: PG.PoseGraph, cfg: GlobalFuserConfig,
                  node_submap=None, node_is_root=None, mesh=None,
                  max_update_index=None, dense_node_limit: int = 2048):
    """Route the pose-graph solve by size — the equivalent of the reference
    picking ``SPARSE_NORMAL_CHOLESKY`` + ``SCHUR_JACOBI`` for every solve
    (``global_fuser.cpp:52-59``):

      * small graphs (≤ ``dense_node_limit`` nodes): dense normal equations
        (:func:`pose_graph.optimize`),
      * larger graphs with submap structure: the submap-sharded Schur
        complement, whose interior factorizations are per-submap (tiny) and
        whose reduced separator system is #submaps-sized.

    ``dense_node_limit=2048`` was chosen for the on-chip memory of the
    accelerator this engine was first built for; it is not yet measured on
    the H100.

    Returns ``(poses, info)``; ``info['solver']`` records the path taken.
    """
    # host-side numpy: the edge filter below must not lower per-tick-shaped
    # eager kernels on a growing online graph (see optimize_bucketed)
    g = jax.tree.map(np.asarray, g)
    N = g.poses.shape[0]
    if max_update_index is not None:
        consecutive = g.id_begin + 1 == g.id_end
        keep = consecutive | (g.id_end <= max_update_index)
        g = g._replace(valid=g.valid & keep)

    def _solve(graph, c):
        if N <= dense_node_limit or node_submap is None or node_is_root is None:
            # bucketed wrapper: online PGO ticks grow (N, E) every call —
            # padding to shape buckets lets successive ticks reuse the same
            # compiled executable
            poses, info = PG.optimize_bucketed(graph, c)
            info["solver"] = "dense"
        else:
            poses, info = optimize_schur(graph, c, node_submap, node_is_root,
                                         mesh=mesh)
            info["solver"] = "schur"
        return poses, info

    if PG.robust_two_stage(cfg):
        # Stage 1: plain least squares to convergence.  Stage 2: re-solve
        # from that optimum with robust IRLS weights — there, the residual of
        # an inconsistent loop edge concentrates on itself (the 472:1
        # inlier majority pins the solution), so the kernel suppresses true
        # outliers instead of genuine drift-corrupted loops at init.
        import dataclasses

        pre = dataclasses.replace(cfg, use_robust_loss=False,
                                  dcs_loop_defense=False)
        poses1, _ = _solve(g, pre)
        if cfg.dcs_loop_defense:
            # the shipped defense: stage 2 is DCS on loop edges only, at
            # dcs_scale (robust_spec deliberately ignores dcs_loop_defense
            # so that single-stage entry points stay quadratic)
            stage2 = dataclasses.replace(
                cfg, dcs_loop_defense=False, use_robust_loss=True,
                robust_kernel="dcs", robust_loop_edges_only=True,
                loss_function_scale=cfg.dcs_scale)
        else:
            stage2 = cfg
        poses, info = _solve(g._replace(poses=poses1), stage2)
        info["two_stage"] = True
        return poses, info
    return _solve(g, cfg)


def benchmark_schur_iteration(g: PG.PoseGraph, cfg: GlobalFuserConfig,
                              node_submap, node_is_root, mesh=None,
                              iters: int = 10) -> float:
    """Wall seconds per Schur GN iteration (reduced system + back
    substitution), compile excluded.  Used for the multi-device scaling
    measurement in ``dryrun_multichip``."""
    import time

    dtype = g.poses.dtype
    pb = _prepare(g, cfg, node_submap, node_is_root, mesh)
    K = pb.kernels
    lam = jnp.asarray(1e-6, dtype)
    C_red, g_red, _, fact = K["reduced_system"](
        pb.poses, pb.edges, pb.lay_rows, pb.dof_rows, pb.ss, lam,
        pb.scale)                                          # compile
    dsep = K["solve_sep"](C_red, g_red, pb.sep_free, lam)
    dint = K["back_substitute"](fact, pb.dof_rows, dsep)   # compile
    jax.block_until_ready(dint)
    t0 = time.perf_counter()
    for _ in range(iters):
        C_red, g_red, _, fact = K["reduced_system"](
            pb.poses, pb.edges, pb.lay_rows, pb.dof_rows, pb.ss, lam,
            pb.scale)
        dsep = K["solve_sep"](C_red, g_red, pb.sep_free, lam)
        dint = K["back_substitute"](fact, pb.dof_rows, dsep)
    jax.block_until_ready(dint)
    return (time.perf_counter() - t0) / iters
