"""Incremental Cholesky factorization — the replacement for the
reference's ``BlockMatrix2x2`` Schur-complement machinery
(``linops/_block.py:192-268``).

The reference stores the Gram matrix as a nested tree of 2x2 block
operators, each level caching its own Cholesky factor and solving
block-recursively.  That recursion maps poorly onto XLA (dynamic
structure, many small kernels).  Instead we keep ONE dense lower-triangular
factor resident in device memory and grow it with the standard block update

    K' = [[K, B], [B^T, D]]
    L' = [[L, 0], [C^T, L_S]],   C = L^{-1} B,  L_S = chol(D - C^T C)

which is a pair of large triangular-solve/matmul ops and
exactly reproduces the `schur_update` capability: conditioning again never
refactorizes the old block.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ...config import config


def _sym(a: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * (a + a.T)


def _is_concrete(x) -> bool:
    import jax.core

    return not isinstance(x, jax.core.Tracer)


def cholesky(gram: jnp.ndarray, jitter: float | None = None) -> jnp.ndarray:
    """Lower Cholesky factor with an explicit nugget policy.

    Operator-transformed kernels on dense collocation grids produce Grams
    that are singular to machine precision (smooth-kernel spectra decay
    exponentially); the reference sidesteps this with tiny N, float64 and
    grid ``inset`` hacks.  Here:

    - a fixed jitter (``config.cholesky_jitter``, relative to the mean
      diagonal) is always applied when configured — this is the traced
      (jitted) path;
    - in eager mode, a failed factorization (NaN diagonal) additionally
      retries with escalating relative jitter — the robustness layer for
      interactive use.
    """
    if jitter is None:
        jitter = config.cholesky_jitter
    gram = _sym(jnp.asarray(gram))
    n = gram.shape[-1]
    eye = jnp.eye(n, dtype=gram.dtype)
    diag_scale = jnp.mean(jnp.diagonal(gram))
    if jitter:
        gram = gram + (jitter * diag_scale) * eye
    chol = jnp.linalg.cholesky(gram)
    if _is_concrete(chol):
        eps = float(jnp.finfo(gram.dtype).eps)
        rel = eps
        while bool(jnp.isnan(chol).any()) and rel < 1e7 * eps:
            chol = jnp.linalg.cholesky(gram + (rel * diag_scale) * eye)
            rel *= 100.0
    return chol


def solve_triangular(chol_lower: jnp.ndarray, b: jnp.ndarray, *, trans: bool = False) -> jnp.ndarray:
    """Solve ``L x = b`` (or ``L^T x = b`` when ``trans``)."""
    vector = b.ndim == 1
    if vector:
        b = b[:, None]
    x = jsl.solve_triangular(chol_lower, b, lower=True, trans=1 if trans else 0)
    return x[:, 0] if vector else x


def cho_solve(chol_lower: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve ``(L L^T) x = b``."""
    return solve_triangular(chol_lower, solve_triangular(chol_lower, b), trans=True)


def chol_extend(
    chol_lower: jnp.ndarray, cross: jnp.ndarray, block: jnp.ndarray
) -> jnp.ndarray:
    """Extend a Cholesky factor by one observation block.

    Parameters
    ----------
    chol_lower:
        ``(n, n)`` lower factor of the existing Gram block ``K``.
    cross:
        ``(n, m)`` cross block ``B = K(old, new)``.
    block:
        ``(m, m)`` new diagonal Gram block ``D`` (noise already added).

    Returns the ``(n+m, n+m)`` lower factor of ``[[K, B], [B^T, D]]``.
    """
    n = chol_lower.shape[0]
    m = block.shape[0]
    c = jsl.solve_triangular(chol_lower, cross, lower=True)  # (n, m)
    schur = _sym(block - jnp.matmul(c.T, c, precision=jax.lax.Precision.HIGHEST))
    chol_schur = cholesky(schur)
    dtype = chol_lower.dtype
    top = jnp.concatenate([chol_lower, jnp.zeros((n, m), dtype)], axis=1)
    bottom = jnp.concatenate([c.T, chol_schur], axis=1)
    return jnp.concatenate([top, bottom], axis=0)


def logdet_from_chol(chol_lower: jnp.ndarray) -> jnp.ndarray:
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol_lower)))
