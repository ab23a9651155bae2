"""Radar NDT SLAM engine in JAX / XLA.

A from-scratch re-architecture of the capabilities of RaNDT SLAM
(IGMR-RWTH/RaNDT-SLAM, IROS 2024) for accelerators: fixed-shape batched
tensors, vmapped per-cell/per-residual math, a batched Gauss-Newton /
Levenberg-Marquardt smoother with Barron-loss graduated non-convexity,
vectorized ScanContext loop closure, and batched pose-graph optimization.
"""

import os as _os

# Persistent XLA compilation cache, in ``JAX_COMPILATION_CACHE_DIR`` when it
# is set and in the checkout's ``.jax_cache/`` otherwise: pipeline-step
# compiles take tens of seconds, and caching them to disk lets a re-run
# (tests, bench, CLI) skip them.  Opt out with RANDT_NO_COMPILE_CACHE=1.
if not _os.environ.get("RANDT_NO_COMPILE_CACHE"):
    _cache_dir = _os.environ.setdefault(
        "JAX_COMPILATION_CACHE_DIR",
        _os.path.join(_os.path.dirname(_os.path.dirname(__file__)),
                      ".jax_cache"),
    )
    _os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1.0")

    import jax as _jax  # set programmatically too, in case jax was imported
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# Full float32 matmul precision by default.  On the GPU, XLA's default lets
# float32 matmuls run in TF32 on the tensor cores (about three decimal
# digits); `highest` keeps them in true float32.  This workload's
# accuracy-critical contractions are small-matrix state-estimation math
# (SE(2) transforms of cell distributions, 3x3 covariance whitening, window
# Jacobians) where reduced-precision rounding is catastrophic: the synthetic
# e2e run diverged from 0.09 m ATE (float32) to 12.5 m (bf16 inputs) once
# cell intensity variance is realistic.  Opt out with
# RANDT_MATMUL_PRECISION=default|high|highest.
import jax as _jax2

_jax2.config.update(
    "jax_default_matmul_precision",
    _os.environ.get("RANDT_MATMUL_PRECISION", "highest"),
)

from . import config, geometry  # noqa: F401

__version__ = "0.1.0"
