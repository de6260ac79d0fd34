"""Mixed-precision iterative refinement for Gram solves.

The reference attains ~machine-precision posteriors by running float64
end-to-end on CPU (``tests/linpde_gp/randprocs/test_posterior_gp.py:
152-162`` asserts against a naive float64 Cholesky GP).  Where float32
runs much faster than float64, the recipe splits the work by precision:

- the O(n^3) Cholesky runs ONCE in float32 (+ a 1e-6-relative nugget for
  factorizability);
- the float64 system is then solved by preconditioned CG where each
  iteration is one float64 mat-vec (O(n^2)) plus one triangular solve
  against the float32 factor.

Two details are load-bearing (measured on the Poisson-1D Dirichlet
config, whose Gram is singular to machine precision):

1. **The Gram must be kept in float64.**  Rounding the Gram entries to
   float32 destroys exactly the small-eigenvalue information the 1e-6
   parity target needs — no refinement can recover it afterwards.
2. **The preconditioner must be APPLIED in float64** (upcast the float32
   factor, triangular-solve in f64).  Applying it in float32 makes M
   inexact at the 1e-7 level and CG breaks down once the residual drops
   below that; applied in f64 the very same factor is an exact SPD
   operator and CG converges monotonically.

The refined system is ``G + jt*mean(diag)*I`` with ``jt ~ 1e-12`` — the
same eps-scale nugget the float64 eager path uses — so the preconditioned
spectrum is bounded by ~``j32/jt`` and PCG converges in O(100)
iterations.  Result on Poisson-1D: max posterior-mean error vs the
analytic solution 9.5e-9 (vs 7.6e-9 for the pure-f64 factorization and
1.8e-4 for plain float32) — restoring the reference's 1e-6 parity target
(BASELINE.md row 3) with the cubic work in float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ...config import config
from .chol import cho_solve
from .pcg import pcg


def refined_solve(
    gram: jnp.ndarray,
    chol_lo: jnp.ndarray,
    b: jnp.ndarray,
    *,
    tol: float | None = None,
    maxiter: int | None = None,
    target_jitter: float | None = None,
) -> jnp.ndarray:
    """Solve ``(gram + jt*I) @ x = b`` in ``gram``'s (high) precision,
    preconditioned by a low-precision Cholesky factor.

    ``gram``: (n, n) SPD, high precision (float64).
    ``chol_lo``: (n, n) lower factor of ``gram`` rounded to low precision
    (typically float32, factored with a ~1e-6 relative nugget).
    ``b``: (n,) or (n, m).
    """
    hi = gram.dtype
    if tol is None:
        tol = config.refine_tol or 30.0 * float(jnp.finfo(hi).eps)
    if maxiter is None:
        maxiter = config.refine_maxiter
    if target_jitter is None:
        target_jitter = config.refine_target_jitter

    # Upcast ONCE: the f32 factor becomes an exact SPD operator in f64.
    chol_hi = chol_lo.astype(hi)

    def precond(r):
        return cho_solve(chol_hi, r)

    jt = target_jitter * jnp.mean(jnp.diagonal(gram))

    def matvec(v):
        return jnp.matmul(gram, v, precision=jax.lax.Precision.HIGHEST) + jt * v

    b = jnp.asarray(b, hi)
    if b.ndim == 1:
        return pcg(matvec, b, M=precond, tol=tol, maxiter=maxiter).x

    def solve_col(col):
        return pcg(matvec, col, M=precond, tol=tol, maxiter=maxiter).x

    return jax.vmap(solve_col, in_axes=1, out_axes=1)(b)
