"""Segment sums of per-point channel vectors.

The scan-NDT build accumulates per-cluster sufficient statistics
(n, Σp, Σppᵀ) over the filtered points into cluster slots (reference:
``Cell::updateCell`` point loops, ``RS/src/ndt_representation/
ndt_cell.cpp:43-65``, driven per cluster from ``Map::insertCluster``):

    out[s, c] = Σ_p [ids[p] == s] · values[p, c]

Both reductions are ``jax.ops.segment_sum`` (a scatter-add) left to XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def segment_moments(values, ids, num_segments: int):
    """Masked segment sum: out[s] = Σ_p [ids[p] == s] values[p].

    values: (P, CH) float32; ids: (P,) int32, entries outside [0, num_segments)
    are dropped (summed into a spill row that is cut off).
    """
    with jax.named_scope("segment_moments"):
        safe = jnp.where((ids >= 0) & (ids < num_segments), ids, num_segments)
        return jax.ops.segment_sum(
            values, safe, num_segments=num_segments + 1)[:num_segments]


def segment_topk_moments(values, ids, num_segments: int, k: int):
    """Segment sum + top-k compaction: reduce ``values`` into the ``k``
    segments with the largest channel-0 sums, returning ``(out (k, CH),
    seg_ids (k,))`` ordered by descending channel-0 sum.

    Channel 0 must be the per-point weight (point count): the scan-NDT build
    keeps only the ``max_scan_cells`` most-populated cells.
    """
    full = segment_moments(values, ids, num_segments)
    _, topi = jax.lax.top_k(full[:, 0], k)
    return full[topi], topi
