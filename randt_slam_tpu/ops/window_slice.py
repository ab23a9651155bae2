"""Per-row contiguous window extraction.

The radar intensity filter gathers a fixed window of range bins around each
azimuth's peak (``RadarPreprocessor::filterScan`` expands runs around the
per-beam maximum, ``RS/src/radar_preprocessing/radar_preprocessor.cpp:45-125``;
this build bounds the run to a window).  One ``take_along_axis`` gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def row_windows(img, rng_row, starts, win: int):
    """Extract ``win``-wide contiguous windows per row:
    out_img[a, w] = img[a, starts[a] + w], out_rng[a, w] = rng_row[starts[a]+w].

    ``starts`` must satisfy 0 <= start and start + win <= img.shape[1] (the
    caller pre-pads the image); columns past the edge are clamped.
    """
    R = img.shape[1]
    with jax.named_scope("row_windows"):
        jw = starts[:, None].astype(jnp.int32) + jnp.arange(win)[None, :]
        jw_c = jnp.clip(jw, 0, R - 1)
        iw = jnp.take_along_axis(img, jw_c, axis=1)
        rw = rng_row[jw_c]
    return iw, rw
