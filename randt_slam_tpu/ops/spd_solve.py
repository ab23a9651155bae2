"""Small dense SPD solve as one Pallas (Triton) kernel.

The window estimator's LM loop solves a damped, Jacobi-scaled 36x36 system
``A x = b`` every iteration, tens of times per frame.  XLA lowers
``jnp.linalg.solve`` on the GPU to a cuSOLVER LU (``getrf``), two triangular
solves and the pivot gathers: five launches for a problem a single thread
block finishes in registers.  This kernel runs the whole solve in one
program: Gaussian elimination without pivoting, then back substitution, on a
power-of-two tile padded with identity rows.  On an H100 at 700 W it cut
the front-end scan from 6.98 to 5.00 ms/frame (PERF.md).

No pivoting is needed: ``A`` is symmetric positive definite (Gauss-Newton
``JᵀWJ`` plus positive Marquardt damping), for which elimination without
pivoting is the Cholesky factorization up to row scaling and has no element
growth.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _kernel(a_ref, b_ref, x_ref, *, n: int):
    N = a_ref.shape[0]
    A = a_ref[...]
    b = b_ref[...]
    rows = jax.lax.broadcasted_iota(jnp.int32, (N, N), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (N, N), 1)
    idx = jax.lax.broadcasted_iota(jnp.int32, (N,), 0)

    def pick(v, k):
        return jnp.sum(jnp.where(idx == k, v, 0.0))

    def eliminate(k, carry):
        A, b = carry
        row_k = jnp.sum(jnp.where(rows == k, A, 0.0), axis=0)
        col_k = jnp.sum(jnp.where(cols == k, A, 0.0), axis=1)
        f = jnp.where(idx > k, col_k / pick(row_k, k), 0.0)
        return A - f[:, None] * row_k[None, :], b - f * pick(b, k)

    A, b = jax.lax.fori_loop(0, n, eliminate, (A, b))

    def substitute(i, x):
        k = n - 1 - i
        row_k = jnp.sum(jnp.where(rows == k, A, 0.0), axis=0)
        xk = (pick(b, k) - jnp.sum(row_k * x)) / pick(row_k, k)
        return jnp.where(idx == k, xk, x)

    x_ref[...] = jax.lax.fori_loop(0, n, substitute, jnp.zeros_like(b))


@functools.partial(jax.jit, static_argnames=("interpret",))
def spd_solve(A, b, interpret: bool = False):
    """Solve ``A x = b`` for one symmetric positive definite ``A`` (n, n).

    ``interpret=True`` runs the kernel through the Pallas interpreter (CPU
    tests); otherwise it compiles for the GPU through Triton.
    """
    n = A.shape[-1]
    N = max(16, pl.next_power_of_2(n))
    pad_eye = np.diag((np.arange(N) >= n).astype(np.float32))
    Ap = jnp.pad(A, ((0, N - n), (0, N - n))) + pad_eye.astype(A.dtype)
    bp = jnp.pad(b, (0, N - n))
    x = pl.pallas_call(
        functools.partial(_kernel, n=n),
        out_shape=jax.ShapeDtypeStruct((N,), b.dtype),
        # one warp: every reduction stays in warp shuffles (1, 2 and 4
        # warps measured within 3 % of each other on the H100)
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="spd_solve",
    )(Ap, bp)
    return x[:n]
