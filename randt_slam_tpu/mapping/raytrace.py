"""Batched occupancy raytracing into per-submap counting grids.

Replaces ``HierarchicalMap::raytraceLine`` / ``bresenham2D``
(``RS/src/ndt_representation/ndt_hierarchical_map.cpp:87-149``), which walk
one ray at a time from a host-side queue guarded by busy-wait flags
(``local_fuser.cpp:302-316``).  This build traces ALL beams of ALL
keyframes as one fixed-shape scatter, evaluating the integer Bresenham
recurrence in closed form per step so the traversed cell set matches the
reference EXACTLY (free space -1 per traversed cell, +2 at the hit cell,
:126-149) — verified against the native C++ transcription in
``tests/test_native.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry import compose


def ray_cells(origin_xy, angle, rng, res, size_x, size_y, max_steps: int):
    """Trace one ray into grid cells — EXACT vectorized integer Bresenham.

    Replicates ``raytraceLine``/``bresenham2D`` arithmetic cell for cell
    (``ndt_hierarchical_map.cpp:92-149``): origin cell from truncation of
    (o/res + size/2), displacement from truncation of ((end - origin)/res),
    then the minor-axis progression in closed form,
        b(i) = (abs_da/2 + i * abs_db) // abs_da,
    which equals the reference's incremental error accumulator.  Returns
    (flat_idx (S,), free_mask (S,), end_idx (), end_ok ()).
    """
    ex = origin_xy[0] + jnp.cos(angle) * rng
    ey = origin_xy[1] + jnp.sin(angle) * rng
    x0 = jnp.trunc(origin_xy[0] / res + size_x / 2).astype(jnp.int32)
    y0 = jnp.trunc(origin_xy[1] / res + size_y / 2).astype(jnp.int32)
    dx = jnp.trunc((ex - origin_xy[0]) / res).astype(jnp.int32)
    dy = jnp.trunc((ey - origin_xy[1]) / res).astype(jnp.int32)

    abs_dx, abs_dy = jnp.abs(dx), jnp.abs(dy)
    x_major = abs_dx >= abs_dy
    abs_da = jnp.where(x_major, abs_dx, abs_dy)
    abs_db = jnp.where(x_major, abs_dy, abs_dx)
    sa = jnp.where(x_major, jnp.sign(dx), jnp.sign(dy))
    sb = jnp.where(x_major, jnp.sign(dy), jnp.sign(dx))

    # ray-length cap (``raytraceLine`` scale, :105-106; max_length = 2*range
    # never binds in practice but is reproduced)
    dist = jnp.hypot(dx.astype(jnp.float32), dy.astype(jnp.float32))
    max_len_cells = 2.0 * rng / res
    scale = jnp.where(dist == 0.0, 1.0, jnp.minimum(1.0, max_len_cells / dist))
    end_steps = (scale * abs_da.astype(jnp.float32)).astype(jnp.int32)

    i = jnp.arange(max_steps, dtype=jnp.int32)
    live = i < jnp.minimum(end_steps, abs_da)
    da_safe = jnp.maximum(abs_da, 1)
    b = (abs_da // 2 + i * abs_db) // da_safe  # minor-axis progression
    a_pos = i * sa
    b_pos = b * sb
    ix = jnp.where(x_major, x0 + a_pos, x0 + b_pos)
    iy = jnp.where(x_major, y0 + b_pos, y0 + a_pos)
    inb = (ix >= 0) & (ix < size_x) & (iy >= 0) & (iy < size_y)
    flat = iy * size_x + ix
    free = live & inb

    # hit cell = position after the final step (the reference's post-loop +2)
    n = jnp.minimum(end_steps, abs_da)
    b_end = (abs_da // 2 + n * abs_db) // da_safe
    eix = jnp.where(x_major, x0 + n * sa, x0 + b_end * sb)
    eiy = jnp.where(x_major, y0 + b_end * sb, y0 + n * sa)
    end_ok = (eix >= 0) & (eix < size_x) & (eiy >= 0) & (eiy < size_y)
    end_idx = eiy * size_x + eix
    free = free & (flat != end_idx)
    return flat, free, end_idx, end_ok


def raytrace_beams(counts, poses, beams, beam_valid, res, max_steps=512):
    """Scatter a batch of beams into a counting grid.

    counts: (H, W) int32 counting grid (submap-local frame)
    poses:  (B, 3) sensor poses in the submap frame per beam
    beams:  (B, 3) [angle, range, intensity] in the sensor frame
            (the per-azimuth max detections, ``local_fuser.cpp:184-187``)
    """
    H, W = counts.shape
    ang = poses[:, 2] + beams[:, 0]
    origin = poses[:, :2]

    flat, free, end_idx, end_ok = jax.vmap(
        lambda o, a, r: ray_cells(o, a, r, res, W, H, max_steps)
    )(origin, ang, beams[:, 1])

    v = beam_valid[:, None] & free
    flat_all = jnp.where(v, flat, H * W).reshape(-1)
    out = counts.reshape(-1)
    out = out.at[flat_all].add(-1, mode="drop")
    end_all = jnp.where(beam_valid & end_ok, end_idx, H * W)
    out = out.at[end_all].add(2, mode="drop")
    return out.reshape(H, W)
