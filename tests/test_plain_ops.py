"""The front end's hot reductions and gathers against numpy float64."""

import jax
import numpy as np
import pytest

from randt_slam_tpu.ops.segment_moments import segment_moments, segment_topk_moments
from randt_slam_tpu.ops.window_slice import row_windows


def _moments_case(P, S, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 10, (P, 13)).astype(np.float32)
    vals[:, 0] = rng.random(P) < 0.8                  # channel 0 = weight
    ids = rng.integers(-20, S + 20, P).astype(np.int32)  # some out of range
    ok = (ids >= 0) & (ids < S)
    want = np.zeros((S, 13))
    np.add.at(want, ids[ok], vals[ok].astype(np.float64))
    return vals, ids, want


# (points, segments, top-k): small, mid, and the Oxford scan size
# (max_points=8192 over (200 m / 3.5 m)^2 = 3265 clusters, max_scan_cells=512)
CASES = [(512, 64, 16), (3000, 700, 128), (8192, 3265, 512)]


@pytest.mark.parametrize("P,S,k", CASES)
def test_segment_moments_matches_numpy(P, S, k):
    vals, ids, want = _moments_case(P, S)
    got = jax.jit(segment_moments, static_argnums=2)(vals, ids, S)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("P,S,k", CASES)
def test_segment_topk_moments_matches_numpy(P, S, k):
    vals, ids, want = _moments_case(P, S, seed=1)
    out, topi = jax.jit(segment_topk_moments, static_argnums=(2, 3))(
        vals, ids, S, k)
    out, topi = np.asarray(out), np.asarray(topi)
    assert out.shape == (k, 13) and topi.shape == (k,)
    np.testing.assert_allclose(out, want[topi], rtol=1e-5, atol=1e-3)
    # the k most-populated segments, in descending count order (ties may
    # pick either id, so compare the counts)
    np.testing.assert_array_equal(out[:, 0], np.sort(want[:, 0])[::-1][:k])


@pytest.mark.parametrize("where", ["left_edge", "right_edge", "interior"])
def test_row_windows_matches_numpy(where):
    rng = np.random.default_rng(2)
    A, width, win = 400, 1157 + 64, 65       # Oxford rows, padded by 32
    img = rng.random((A, width)).astype(np.float32)
    rng_row = rng.random(width).astype(np.float32)
    starts = {
        "left_edge": np.zeros(A, np.int32),
        "right_edge": np.full(A, width - win, np.int32),
        "interior": rng.integers(1, width - win, A).astype(np.int32),
    }[where]
    iw, rw = jax.jit(row_windows, static_argnums=3)(img, rng_row, starts, win)
    cols = starts[:, None] + np.arange(win)
    np.testing.assert_array_equal(np.asarray(iw),
                                  np.take_along_axis(img, cols, axis=1))
    np.testing.assert_array_equal(np.asarray(rw), rng_row[cols])
