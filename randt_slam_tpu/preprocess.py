"""Radar scan preprocessing: azimuth-wise intensity filtering + grid clustering.

Re-architecture of ``RadarPreprocessor::filterScan``
(``RS/src/radar_preprocessing/radar_preprocessor.cpp:45-125``) as batched
array code.  The reference walks an azimuth-organized point cloud with three
sequential loops
(per-beam max, expand closer, expand farther).  Here the scan is a polar
intensity image ``(A azimuths, R range bins)`` — the native Navtech format —
and the filter becomes:

 1. per-row masked argmax                       (the per-beam peak)
 2. a fixed window gathered around each peak    (bounded run length)
 3. a cumulative "strictly-decreasing chain" mask inside the window
    (the two expansion loops, computed as cumsums — no data-dependent loops)

Grid clustering (``grid.cpp:7-14``) becomes a per-point cell-id hash; the
per-cluster moments are one ``segment_sum`` (see ``ndt/cells.py``).

Deviations from the reference (documented):
 * the run is capped at ``run_window`` bins each side of the peak (the
   reference's expansion is unbounded; real blobs span a few bins),
 * cluster ids use ``floor((x+max_range)/res)`` instead of C's
   truncation-toward-zero ``int(x/res)``, which in the reference merges the
   four cells straddling the sensor origin into overlapping labels.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import PreprocessorConfig
from .geometry import transform_points


class PolarScan(NamedTuple):
    """Raw radar frame as a polar intensity image.

    intensity: (A, R) float32 return power per (azimuth, range-bin)
    azimuths:  (A,)   beam angles [rad] in the sensor frame
    ranges:    (R,)   range-bin centers [m]
    azimuth_mask: (A,) bool, False for padded azimuth rows
    """

    intensity: jax.Array
    azimuths: jax.Array
    ranges: jax.Array
    azimuth_mask: jax.Array


class FilteredScan(NamedTuple):
    """Filtered scan: per-azimuth peak runs, flattened to padded points.

    points:  (P, 3) [x, y, intensity] in the BASE frame
    polar:   (P, 2) [angle, range] in the sensor frame (for pNDT)
    mask:    (P,)   bool
    beams:   (A, 3) [angle, range, intensity] of the per-azimuth max return
             (sensor frame; feeds OGM raytracing, ``local_fuser.cpp:181-188``)
    beam_mask: (A,) bool
    """

    points: jax.Array
    polar: jax.Array
    mask: jax.Array
    beams: jax.Array
    beam_mask: jax.Array


def filter_scan(
    scan: PolarScan,
    cfg: PreprocessorConfig,
    sensor_to_base,
    run_window: int = 32,
) -> FilteredScan:
    """Vectorized equivalent of ``RadarPreprocessor::filterScan``.

    sensor_to_base: (3,) SE(2) pose of the sensor in the base frame
    run_window: max run extent in bins on EACH side of the peak.
    Returns points flattened to P = A * (2*run_window+1).
    """
    img = scan.intensity
    A, R = img.shape
    r = scan.ranges
    dtype = img.dtype

    range_ok = (r > cfg.min_range) & (r < cfg.max_range)  # (R,)
    gated = jnp.where(range_ok[None, :], img, -jnp.inf)
    peak_idx = jnp.argmax(gated, axis=1)  # (A,)
    peak_int = jnp.take_along_axis(img, peak_idx[:, None], axis=1)[:, 0]
    # A beam has a peak iff some in-range return has intensity > 0
    # (``radar_preprocessor.cpp:71``: candidates need intensity > 0).
    beam_valid = (
        scan.azimuth_mask
        & (jnp.max(jnp.where(range_ok[None, :], img, 0.0), axis=1) > 0.0)
    )

    beams = jnp.stack(
        [scan.azimuths, r[peak_idx], peak_int], axis=-1
    ).astype(dtype)

    # ---- fixed window around each peak -------------------------------------
    # The windows are contiguous spans, gathered per row over an image
    # pre-padded by the window radius;
    # out-of-bounds columns carry sentinel values (intensity 0, range -1e9)
    # and are additionally excluded by the arithmetic ``in_bounds`` mask.
    from .ops.window_slice import row_windows

    W = 2 * run_window + 1
    offsets = jnp.arange(-run_window, run_window + 1)  # (W,), center at run_window
    jw = peak_idx[:, None] + offsets[None, :]  # (A, W)
    in_bounds = (jw >= 0) & (jw < R)
    img_pad = jnp.pad(img, ((0, 0), (run_window, run_window)))
    r_pad = jnp.concatenate(
        [jnp.full(run_window, -1e9, dtype), r.astype(dtype),
         jnp.full(run_window, -1e9, dtype)]
    )
    I_w, r_w = row_windows(img_pad, r_pad, peak_idx, W)  # (A, W)

    c = run_window  # center column
    # Step legality between adjacent window slots (both directions):
    # strictly decreasing intensity, SIGNED range-contiguity
    # (r_cur - r_next > threshold stops — ``radar_preprocessor.cpp:84,99`` —
    # so the outward expansion never stops on range while the inward one
    # requires steps no larger than the threshold), previous bin in range.
    thresh = cfg.beam_distance_increment_threshold
    dI_right = I_w[:, 1:] < I_w[:, :-1]
    dr_right = (r_w[:, :-1] - r_w[:, 1:]) <= thresh  # cur - next(farther)
    prev_in_range_right = r_w[:, :-1] >= cfg.min_range
    ok_right = dI_right & dr_right & prev_in_range_right & in_bounds[:, 1:]

    dI_left = I_w[:, :-1] < I_w[:, 1:]
    dr_left = (r_w[:, 1:] - r_w[:, :-1]) <= thresh  # cur - next(closer)
    prev_in_range_left = r_w[:, 1:] >= cfg.min_range
    ok_left = dI_left & dr_left & prev_in_range_left & in_bounds[:, :-1]

    # Chain from the center: bad-step cumsums.
    bad_r = (~ok_right).astype(jnp.int32)  # step into slot j+1
    cum_r = jnp.cumsum(bad_r, axis=1)  # (A, W-1), cum_r[j] = bad steps up to j+1
    base_r = jnp.take_along_axis(
        cum_r, jnp.full((A, 1), c - 1, jnp.int32), axis=1
    )  # bad steps up to center
    in_run_right = jnp.concatenate(
        [jnp.zeros((A, c + 1), bool), (cum_r[:, c:] - base_r) == 0], axis=1
    )

    bad_l = (~ok_left).astype(jnp.int32)
    cum_l_rev = jnp.cumsum(bad_l[:, ::-1], axis=1)[:, ::-1]  # bad steps from j to end
    base_l = jnp.take_along_axis(
        cum_l_rev, jnp.full((A, 1), c, jnp.int32), axis=1
    )
    in_run_left = jnp.concatenate(
        [(cum_l_rev[:, : c] - base_l) == 0, jnp.zeros((A, W - c), bool)], axis=1
    )

    in_run = in_run_left | in_run_right
    in_run = in_run.at[:, c].set(True)

    # Final inclusion gates (``radar_preprocessor.cpp:114``).
    keep = (
        in_run
        & in_bounds
        & beam_valid[:, None]
        & (r_w > cfg.min_range)
        & (r_w < cfg.max_range)
        & (I_w > cfg.min_intensity)
    )

    ang = scan.azimuths[:, None]  # (A, 1)
    xs = jnp.cos(ang) * r_w
    ys = jnp.sin(ang) * r_w
    pts_sensor = jnp.stack([xs, ys], axis=-1).reshape(A * W, 2)
    pts_base = transform_points(sensor_to_base.astype(dtype), pts_sensor)
    points = jnp.concatenate([pts_base, I_w.reshape(A * W, 1)], axis=-1)
    polar = jnp.stack(
        [jnp.broadcast_to(ang, (A, W)).reshape(-1), r_w.reshape(-1)], axis=-1
    )
    return FilteredScan(
        points=points,
        polar=polar,
        mask=keep.reshape(-1),
        beams=beams,
        beam_mask=beam_valid,
    )


def cluster_ids(points, mask, cfg: PreprocessorConfig):
    """Grid-hash cluster labels (``Grid::cluster``, ``grid.cpp:7-14``).

    Returns (ids (P,), num_slots): id in [0, row_size^2), invalid points get
    id == num_slots (dropped by segment_sum).
    """
    rs = cfg.cluster_row_size
    res = cfg.cluster_resolution
    num_slots = rs * rs
    ix = jnp.floor((points[..., 0] + cfg.max_range) / res).astype(jnp.int32)
    iy = jnp.floor((points[..., 1] + cfg.max_range) / res).astype(jnp.int32)
    ok = mask & (ix >= 0) & (ix < rs) & (iy >= 0) & (iy < rs)
    ids = jnp.where(ok, ix + rs * iy, num_slots)
    return ids, num_slots
