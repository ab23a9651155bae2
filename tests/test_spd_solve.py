"""The LM window solve: the Pallas kernel (interpret mode here) and the
per-device choice between it and XLA's LU, against numpy float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randt_slam_tpu.ops.spd_solve import spd_solve
from randt_slam_tpu.registration import solver


def _damped_system(n, spread, seed=0):
    """A Jacobi-scaled, Marquardt-damped Gauss-Newton matrix, as the LM loop
    builds it: unit diagonal after scaling, curvatures spread over
    ``spread`` decades before it."""
    rng = np.random.default_rng(seed)
    J = rng.normal(0, 1, (3 * n, n)) * np.logspace(0, spread, n)[None, :]
    A = J.T @ J
    d = 1.0 / np.sqrt(np.diag(A))
    A = A * d[:, None] * d[None, :] + 1e-4 * np.eye(n)
    return A, rng.normal(0, 1, n)


@pytest.mark.parametrize("n,spread", [(3, 2), (9, 4), (36, 4), (36, 8)])
def test_spd_solve_kernel_matches_numpy(n, spread):
    A, b = _damped_system(n, spread)
    x = np.asarray(spd_solve(jnp.asarray(A, jnp.float32),
                             jnp.asarray(b, jnp.float32), interpret=True),
                   np.float64)
    assert x.shape == (n,)
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) <= 1e-4


def test_spd_solve_kernel_under_vmap():
    systems = [_damped_system(36, 4, seed=s) for s in range(3)]
    A = jnp.asarray(np.stack([a for a, _ in systems]), jnp.float32)
    b = jnp.asarray(np.stack([v for _, v in systems]), jnp.float32)
    x = jax.vmap(lambda a, v: spd_solve(a, v, interpret=True))(A, b)
    want = np.stack([np.linalg.solve(a, v) for a, v in systems])
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-3, atol=1e-4)


def test_solve_damped_uses_lu_off_cuda():
    """On a non-CUDA device the LM loop's solve lowers to XLA's LU, not to
    the Triton kernel (which has no CPU lowering)."""
    A, b = _damped_system(36, 4)
    f = jax.jit(solver.solve_damped)
    hlo = f.lower(jnp.asarray(A, jnp.float32),
                  jnp.asarray(b, jnp.float32)).compile().as_text()
    assert "triton" not in hlo and "getrf" in hlo
    np.testing.assert_allclose(
        np.asarray(f(jnp.asarray(A, jnp.float32), jnp.asarray(b, jnp.float32))),
        np.linalg.solve(A, b), rtol=1e-3, atol=1e-4)
