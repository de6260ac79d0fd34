r"""Preconditioned conjugate gradients + Nyström preconditioner.

The reference scales via KeOps' lazy O(N²)-compute/O(N)-memory kernel
reductions (SURVEY.md §5; reference ``covfuncs/_tensor_product.py:111-130``)
but always solves densely.  The gram-free path here replaces the dense
solve with CG over streaming matvecs (``models/iterative.py``); this
module supplies the two pieces that make that path fast:

- :func:`pcg` — preconditioned CG as a ``lax.while_loop`` (static shapes,
  single compiled program, no host round-trips per iteration), returning
  the iteration count and final relative residual for observability.
- :func:`nystrom_preconditioner` — a rank-``m`` Nyström approximation
  ``K ≈ U Λ Uᵀ`` of the (operator-transformed) kernel matrix, inverted
  in closed form via Woodbury against the noise term:

      P⁻¹ r = U ((Λ + σ²)⁻¹ − σ⁻²) Uᵀ r + σ⁻² r.

  Smooth-kernel Grams have rapidly decaying spectra, so a small ``m``
  captures the dominant eigenspace and PCG converges in O(10) iterations
  where plain CG needs hundreds (the classic randomized-preconditioning
  recipe for kernel ridge regression).  Cost: one (n × m) kernel block,
  one thin SVD — O(n m²) matmuls, O(n m) memory.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class PCGResult(NamedTuple):
    x: jnp.ndarray
    iterations: jnp.ndarray
    relative_residual: jnp.ndarray


def pcg(
    matvec: Callable,
    b: jnp.ndarray,
    *,
    M: Callable | None = None,
    tol: float = 1e-6,
    maxiter: int = 512,
    x0: jnp.ndarray | None = None,
) -> PCGResult:
    """Solve ``A x = b`` (A SPD) by preconditioned conjugate gradients.

    ``M`` applies an approximation of ``A⁻¹``.  The loop is a
    ``lax.while_loop`` — jittable, differentiable-free hot path, one
    compiled program regardless of iteration count.

    Examples
    --------
    >>> import numpy as np, jax.numpy as jnp
    >>> d = jnp.asarray([1.0, 2.0, 3.0])
    >>> res = pcg(lambda v: d * v, jnp.ones(3), tol=1e-12)
    >>> int(res.iterations)
    3
    >>> np.round(np.asarray(res.x), 6)
    array([1.      , 0.5     , 0.333333])
    """
    if M is None:
        M = lambda r: r  # noqa: E731

    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    r = b - matvec(x) if x0 is not None else b
    z = M(r)
    p = z
    rz = jnp.vdot(r, z)
    b_norm = jnp.linalg.norm(b)
    # Absolute threshold on ||r||; guard b == 0.
    threshold = tol * jnp.where(b_norm > 0, b_norm, 1.0)

    def cond(state):
        _, r, _, _, k = state
        return jnp.logical_and(jnp.linalg.norm(r) > threshold, k < maxiter)

    def body(state):
        x, r, p, rz, k = state
        Ap = matvec(p)
        alpha = rz / jnp.vdot(p, Ap)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z = M(r_new)
        rz_new = jnp.vdot(r_new, z)
        # Polak–Ribière beta (flexible CG): in exact arithmetic z'r = 0
        # and this equals Fletcher–Reeves, but with an INEXACT operator
        # (float32 streaming matvec, ~4e-6 relative noise) FR loses
        # conjugacy and diverges once the residual nears the noise floor
        # (at n=1e5: relres 0.22 -> 3.0 over 20 iterations); PR
        # self-corrects, clamped at 0 (= restart).
        beta = jnp.maximum((rz_new - jnp.vdot(z, r)) / rz, 0.0)
        p = z + beta * p
        return x, r_new, p, rz_new, k + 1

    x, r, _, _, k = jax.lax.while_loop(cond, body, (x, r, p, rz, jnp.array(0)))
    relres = jnp.linalg.norm(r) / jnp.where(b_norm > 0, b_norm, 1.0)
    return PCGResult(x, k, relres)


def pcg_host(
    matvec: Callable,
    b,
    *,
    M: Callable | None = None,
    tol: float = 1e-6,
    maxiter: int = 512,
) -> PCGResult:
    """Host-orchestrated preconditioned CG (same method as :func:`pcg`:
    flexible Polak–Ribière, beta clamped at 0).

    ``matvec`` and ``M`` are called once per iteration as ordinary
    Python callables — typically separately ``jax.jit``-ed device
    programs — while the O(n) vector arithmetic runs on the host in
    numpy float64.  Compared to the ``lax.while_loop`` of :func:`pcg`
    this splits the iteration body into SEPARATE device programs (the
    streaming matvec and the Nyström apply), and host-f64 vectors remove
    the f32 CG-arithmetic floor when the device program runs in float32.
    Per-iteration overhead is two dispatches plus two O(n) host↔device
    copies.

    Examples
    --------
    >>> import numpy as np
    >>> d = np.asarray([1.0, 2.0, 3.0])
    >>> res = pcg_host(lambda v: d * v, np.ones(3), tol=1e-12)
    >>> int(res.iterations)
    3
    >>> np.round(np.asarray(res.x), 6)
    array([1.      , 0.5     , 0.333333])
    """
    import numpy as np

    if M is None:
        M = lambda r: r  # noqa: E731

    def dev(fn, v):
        return np.asarray(fn(v), dtype=np.float64)

    b = np.asarray(b, dtype=np.float64)
    x = np.zeros_like(b)
    r = b.copy()
    z = dev(M, r)
    p = z
    rz = float(r @ z)
    b_norm = float(np.linalg.norm(b))
    threshold = tol * (b_norm if b_norm > 0 else 1.0)

    k = 0
    while float(np.linalg.norm(r)) > threshold and k < maxiter:
        Ap = dev(matvec, p)
        alpha = rz / float(p @ Ap)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z = dev(M, r_new)
        rz_new = float(r_new @ z)
        beta = max((rz_new - float(z @ r)) / rz, 0.0)
        p = z + beta * p
        r, rz = r_new, rz_new
        k += 1

    relres = float(np.linalg.norm(r)) / (b_norm if b_norm > 0 else 1.0)
    return PCGResult(x, np.asarray(k), np.asarray(relres))


def pcg_block(
    matvec: Callable,
    B: jnp.ndarray,
    *,
    M: Callable | None = None,
    tol: float = 1e-6,
    maxiter: int = 512,
) -> PCGResult:
    """Solve ``A X = B`` for a block of right-hand sides SHARING the
    matvec: one ``matvec((n, r))`` application per iteration serves all
    ``r`` columns (each with its own step sizes), so the dominant cost —
    the O(n²) streaming Gram reduction — is amortized r-fold vs ``r``
    independent CG solves.  This is what makes gram-free posterior
    VARIANCE sweeps viable at the 1e5-point scale.

    Converged columns are frozen (masked updates) so late stragglers
    cannot corrupt finished solutions; the loop ends when every column's
    residual is below ``tol * ||b_col||`` or at ``maxiter``.
    """
    if M is None:
        M = lambda r: r  # noqa: E731

    B = jnp.asarray(B)
    X = jnp.zeros_like(B)
    R = B
    Z = M(R)
    P = Z
    rz = jnp.sum(R * Z, axis=0)  # (r,)
    b_norm = jnp.linalg.norm(B, axis=0)
    threshold = tol * jnp.where(b_norm > 0, b_norm, 1.0)

    def cond(state):
        _, R, _, _, k = state
        return jnp.logical_and(
            jnp.any(jnp.linalg.norm(R, axis=0) > threshold), k < maxiter
        )

    def body(state):
        X, R, P, rz, k = state
        active = jnp.linalg.norm(R, axis=0) > threshold  # (r,)
        AP = matvec(P)
        pAp = jnp.sum(P * AP, axis=0)
        alpha = jnp.where(active, rz / jnp.where(pAp != 0, pAp, 1.0), 0.0)
        X = X + alpha[None, :] * P
        R_new = R - alpha[None, :] * AP
        Z = M(R_new)
        rz_new = jnp.sum(R_new * Z, axis=0)
        # Polak–Ribière beta per column (see pcg: flexible CG under an
        # inexact streaming matvec), clamped at 0 (= restart).
        pr = rz_new - jnp.sum(Z * R, axis=0)
        beta = jnp.where(
            active, jnp.maximum(pr / jnp.where(rz != 0, rz, 1.0), 0.0), 0.0
        )
        P = Z + beta[None, :] * P
        return X, R_new, P, jnp.where(active, rz_new, rz), k + 1

    X, R, _, _, k = jax.lax.while_loop(cond, body, (X, R, P, rz, jnp.array(0)))
    relres = jnp.max(jnp.linalg.norm(R, axis=0) / jnp.where(b_norm > 0, b_norm, 1.0))
    return PCGResult(X, k, relres)


def pcg_block_host(
    matvec: Callable,
    B,
    *,
    M: Callable | None = None,
    tol: float = 1e-6,
    maxiter: int = 512,
) -> PCGResult:
    """Host-orchestrated blocked multi-RHS PCG (the :func:`pcg_block`
    method — per-column steps, frozen converged columns, flexible
    Polak–Ribière — driven from the host like :func:`pcg_host`).

    One ``matvec((n, r))`` device call per iteration serves all ``r``
    right-hand sides; the O(n·r) vector arithmetic runs in host float64.
    """
    import numpy as np

    if M is None:
        M = lambda r: r  # noqa: E731

    def dev(fn, v):
        return np.asarray(fn(v), dtype=np.float64)

    B = np.asarray(B, dtype=np.float64)
    X = np.zeros_like(B)
    R = B.copy()
    Z = dev(M, R)
    P = Z
    rz = np.sum(R * Z, axis=0)
    b_norm = np.linalg.norm(B, axis=0)
    threshold = tol * np.where(b_norm > 0, b_norm, 1.0)

    k = 0
    while np.any(np.linalg.norm(R, axis=0) > threshold) and k < maxiter:
        active = np.linalg.norm(R, axis=0) > threshold
        AP = dev(matvec, P)
        pAp = np.sum(P * AP, axis=0)
        alpha = np.where(active, rz / np.where(pAp != 0, pAp, 1.0), 0.0)
        X = X + alpha[None, :] * P
        R_new = R - alpha[None, :] * AP
        Z = dev(M, R_new)
        rz_new = np.sum(R_new * Z, axis=0)
        pr = rz_new - np.sum(Z * R, axis=0)
        beta = np.where(
            active, np.maximum(pr / np.where(rz != 0, rz, 1.0), 0.0), 0.0
        )
        P = Z + beta[None, :] * P
        R = R_new
        rz = np.where(active, rz_new, rz)
        k += 1

    relres = float(
        np.max(np.linalg.norm(R, axis=0) / np.where(b_norm > 0, b_norm, 1.0))
    )
    return PCGResult(X, np.asarray(k), np.asarray(relres))


# -- float-float CG scalar helpers ------------------------------------------
#
# The device-state CG below keeps its vectors as float-float (hi, lo)
# pairs (ops/ff.py): f32 storage, ~eps32^2 accumulation accuracy — the
# on-device replacement for pcg_host's host-float64 vector arithmetic
# (pure-f32 CG vectors stall at ~6e-4 relres).


def ff_sub(x, y):
    from ..ff import two_sum

    s, e = two_sum(x[0], -y[0])
    return s, e + (x[1] - y[1])


def ff_div(a, b):
    """ff scalar division, accurate to ~eps32^2 (one Newton correction)."""
    from ..ff import quick_two_sum, two_prod

    q1 = a[0] / b[0]
    p, e = two_prod(q1, b[0])
    rh, re = ff_sub(a, (p, e + q1 * b[1]))
    q2 = (rh + re) / b[0]
    return quick_two_sum(q1, q2)


def ff_dot(x, y):
    """Dot product of two ff vectors as an ff scalar.

    Per-element products are error-free (two_prod); the reduction sums
    the hi and lo streams separately through XLA's pairwise tree (~eps32
    * log n relative on the positive-summand dots CG uses) and recombines
    in ff.  Accuracy ~1e-7 relative — scalar (alpha/beta) perturbations
    at that level are absorbed by the flexible (Polak-Ribiere) recurrence;
    what needed the precision upgrade was the VECTOR state, which stays
    in ff end-to-end."""
    from ..ff import two_prod, two_sum

    p, e = two_prod(x[0], y[0])
    lo = e + (x[0] * y[1] + x[1] * y[0])
    s, c = two_sum(jnp.sum(p), jnp.sum(lo))
    return s, c


def _ff_axpy(alpha_ff, x_ff, y_ff):
    """y + alpha * x on ff vectors with an ff scalar alpha."""
    from ..ff import ff_add, ff_mul

    return ff_add(y_ff, ff_mul(x_ff, alpha_ff))


def make_pcg_ff_programs(matvec, precond):
    """Build the two fused per-iteration device programs of
    :func:`pcg_ff`.

    ``matvec(mv_aux, v)``: the UNSHIFTED Gram matvec (f32 in/out) — the
    sigma^2 I shift is applied in ff inside the step program.
    ``precond(pc_aux, r)``: preconditioner apply (f32 in/out); pass
    ``None`` for the identity.

    Two programs per iteration (not one fused loop body, and not the
    2-dispatch + 4 O(n)-copy pcg_host pattern either):

    - ``step_A``: matvec + pAp/alpha + x,r updates + ||r||^2 — the big
      streaming program plus O(n) elementwise ff tail.
    - ``step_B``: preconditioner apply + rz / Polak-Ribiere beta + p
      update.

    All CG state (x, r, p as ff pairs) and the rz scalar stay ON DEVICE;
    the host reads only the lagged ||r||^2 scalar per iteration.
    """

    @jax.jit
    def step_A(mv_aux, sigma_ff, x, p, r, rz):
        Kp = matvec(mv_aux, p[0])
        from ..ff import ff_add, ff_mul

        z32 = jnp.zeros_like(Kp)
        Ap = ff_add((Kp, z32), ff_mul(p, sigma_ff))
        pAp = ff_dot(p, Ap)
        alpha = ff_div(rz, pAp)
        x_new = _ff_axpy(alpha, p, x)
        r_new = _ff_axpy((-alpha[0], -alpha[1]), Ap, r)
        rn2 = ff_dot(r_new, r_new)
        return x_new, r_new, rn2[0]

    @jax.jit
    def step_B(pc_aux, r, r_old, p, rz_old):
        if precond is None:
            z = r[0]
        else:
            z = precond(pc_aux, r[0])
        from ..ff import ff_add, ff_mul

        zf = (z, jnp.zeros_like(z))
        rz_new = ff_dot(r, zf)
        zr_old = ff_dot(zf, r_old)
        num = ff_sub(rz_new, zr_old)
        beta = ff_div(num, rz_old)
        # Clamp at 0 (= restart), as in pcg/pcg_host.
        neg = beta[0] < 0
        beta = (
            jnp.where(neg, 0.0, beta[0]).astype(z.dtype),
            jnp.where(neg, 0.0, beta[1]).astype(z.dtype),
        )
        p_new = ff_add(zf, ff_mul(p, beta))
        return p_new, rz_new

    return step_A, step_B


def pcg_ff(
    matvec,
    precond,
    mv_aux,
    pc_aux,
    b,
    sigma_sq: float,
    *,
    tol: float = 1e-6,
    maxiter: int = 512,
    programs=None,
) -> PCGResult:
    """Device-state flexible PCG with float-float vectors.

    Same method as :func:`pcg_host` (flexible Polak-Ribiere, clamp at 0)
    but the O(n) state lives on the device as ff pairs and each iteration
    is exactly two program dispatches with SCALAR-only host traffic — the
    convergence check reads the previous iteration's ||r||^2 while the
    current one is in flight (one-iteration lag hides the readback round
    trip).  vs pcg_host this removes the four O(n) host<->device copies
    and two of the ~4 round trips per iteration.

    ``matvec``/``precond`` are traceable functions (see
    :func:`make_pcg_ff_programs`); ``mv_aux``/``pc_aux`` are their
    operand pytrees, passed as jit ARGUMENTS (closure-captured arrays
    would become program constants).

    Examples
    --------
    >>> import numpy as np, jax.numpy as jnp
    >>> d = jnp.asarray([1.0, 2.0, 3.0], jnp.float32)
    >>> res = pcg_ff(lambda aux, v: aux * v - 0.5 * v, None, d, None,
    ...              jnp.ones(3, jnp.float32), 0.5, tol=1e-12)
    >>> int(res.iterations)  # 3 + convergence-check lag + f32 rounding
    5
    >>> np.round(np.asarray(res.x), 6)
    array([1.      , 0.5     , 0.333333], dtype=float32)
    """
    import numpy as np

    from ..ff import ff_const

    step_A, step_B = programs if programs is not None else make_pcg_ff_programs(
        matvec, precond
    )

    b = jnp.asarray(b)
    dtype = b.dtype
    zeros = jnp.zeros_like(b)
    sigma_ff = tuple(
        jnp.asarray(v, dtype) for v in ff_const(float(sigma_sq), dtype)
    )
    x = (zeros, zeros)
    r = (b, zeros)
    b_norm = float(np.linalg.norm(np.asarray(b, np.float64)))
    threshold2 = (tol * (b_norm if b_norm > 0 else 1.0)) ** 2

    p, rz = step_B(pc_aux, r, (zeros, zeros), (zeros, zeros),
                   (jnp.ones((), dtype), jnp.zeros((), dtype)))

    k = 0
    rn2_prev = None
    rn2_final = jnp.asarray(b_norm**2, dtype)
    while k < maxiter:
        r_old = r
        x, r, rn2 = step_A(mv_aux, sigma_ff, x, p, r, rz)
        p, rz = step_B(pc_aux, r, r_old, p, rz)
        k += 1
        # Lagged convergence check: decide on iteration k-1's residual
        # while iteration k's programs are already enqueued.
        if rn2_prev is not None:
            val = float(np.asarray(rn2_prev))
            if not np.isfinite(val):
                rn2_final = rn2_prev
                break
            if val <= threshold2:
                rn2_final = rn2_prev
                break
        rn2_prev = rn2
        rn2_final = rn2
    relres = float(np.sqrt(max(float(np.asarray(rn2_final)), 0.0))) / (
        b_norm if b_norm > 0 else 1.0
    )
    x_out = x[0] + x[1]
    return PCGResult(x_out, np.asarray(k), np.asarray(relres))


def ff_dot_cols(x, y):
    """Per-column dot products of two (n, r) ff arrays -> (r,) ff pair
    (the blocked-CG analogue of :func:`ff_dot`)."""
    from ..ff import two_prod, two_sum

    p, e = two_prod(x[0], y[0])
    lo = e + (x[0] * y[1] + x[1] * y[0])
    s, c = two_sum(jnp.sum(p, axis=0), jnp.sum(lo, axis=0))
    return s, c


def make_pcg_block_ff_programs(matvec, precond):
    """Two fused per-iteration device programs for :func:`pcg_block_ff`
    (multi-RHS analogue of :func:`make_pcg_ff_programs`): state arrays
    are (n, r) ff pairs, CG scalars are per-column (r,) ff pairs, and
    ``active`` masks freeze converged columns exactly like
    :func:`pcg_block`."""

    @jax.jit
    def step_A(mv_aux, sigma_ff, X, P, R, rz, active):
        from ..ff import ff_add, ff_mul

        KP = matvec(mv_aux, P[0])
        AP = ff_add((KP, jnp.zeros_like(KP)), ff_mul(P, sigma_ff))
        pAp = ff_dot_cols(P, AP)
        safe = (pAp[0] != 0) & active
        denom = (jnp.where(safe, pAp[0], 1.0), jnp.where(safe, pAp[1], 0.0))
        alpha = ff_div(rz, denom)
        alpha = (
            jnp.where(safe, alpha[0], 0.0).astype(KP.dtype),
            jnp.where(safe, alpha[1], 0.0).astype(KP.dtype),
        )
        X_new = _ff_axpy((alpha[0][None, :], alpha[1][None, :]), P, X)
        R_new = _ff_axpy((-alpha[0][None, :], -alpha[1][None, :]), AP, R)
        rn2 = ff_dot_cols(R_new, R_new)
        return X_new, R_new, rn2[0]

    @jax.jit
    def step_B(pc_aux, R, R_old, P, rz_old, active):
        from ..ff import ff_add, ff_mul

        if precond is None:
            Z = R[0]
        else:
            Z = precond(pc_aux, R[0])
        Zf = (Z, jnp.zeros_like(Z))
        rz_new = ff_dot_cols(R, Zf)
        zr_old = ff_dot_cols(Zf, R_old)
        num = ff_sub(rz_new, zr_old)
        safe = (rz_old[0] != 0) & active
        denom = (jnp.where(safe, rz_old[0], 1.0), jnp.where(safe, rz_old[1], 0.0))
        beta = ff_div(num, denom)
        keep = safe & (beta[0] > 0)
        beta = (
            jnp.where(keep, beta[0], 0.0).astype(Z.dtype),
            jnp.where(keep, beta[1], 0.0).astype(Z.dtype),
        )
        P_new = ff_add(Zf, ff_mul(P, (beta[0][None, :], beta[1][None, :])))
        return P_new, rz_new

    return step_A, step_B


def pcg_block_ff(
    matvec,
    precond,
    mv_aux,
    pc_aux,
    B,
    sigma_sq: float,
    *,
    tol: float = 1e-6,
    maxiter: int = 512,
    programs=None,
) -> PCGResult:
    """Device-state multi-RHS flexible PCG with float-float state.

    The blocked analogue of :func:`pcg_ff`: one shared ``matvec((n, r))``
    per iteration serves all ``r`` right-hand sides, the (n, r) CG state
    lives on device as ff pairs, and the host reads only the lagged
    per-column ``||r_j||^2`` vector (r floats) per iteration, where
    ``pcg_block_host`` moves four O(n*r) buffers (~800 MB at n=1e5,
    r=256) between host and device.

    Examples
    --------
    >>> import numpy as np, jax.numpy as jnp
    >>> d = jnp.asarray([1.0, 2.0, 3.0], jnp.float32)
    >>> B = jnp.stack([jnp.ones(3), d], axis=1)
    >>> res = pcg_block_ff(lambda aux, v: aux[:, None] * v - 0.5 * v, None,
    ...                    d, None, B, 0.5, tol=1e-10)
    >>> np.round(np.asarray(res.x, np.float64), 5)
    array([[1.     , 1.     ],
           [0.5    , 1.     ],
           [0.33333, 1.     ]])
    """
    import numpy as np

    from ..ff import ff_const

    step_A, step_B = (
        programs
        if programs is not None
        else make_pcg_block_ff_programs(matvec, precond)
    )

    B = jnp.asarray(B)
    dtype = B.dtype
    r = B.shape[1]
    zeros = jnp.zeros_like(B)
    sigma_ff = tuple(
        jnp.asarray(v, dtype) for v in ff_const(float(sigma_sq), dtype)
    )
    X = (zeros, zeros)
    R = (B, zeros)
    b_norm = np.linalg.norm(np.asarray(B, np.float64), axis=0)
    threshold2 = (tol * np.where(b_norm > 0, b_norm, 1.0)) ** 2

    ones_r = jnp.ones((r,), dtype)
    active = jnp.asarray(np.ones(r, bool))
    P, rz = step_B(pc_aux, R, (zeros, zeros), (zeros, zeros),
                   (ones_r, jnp.zeros((r,), dtype)), active)

    k = 0
    rn2_prev = None
    rn2_final = None
    while k < maxiter:
        R_old = R
        X, R, rn2 = step_A(mv_aux, sigma_ff, X, P, R, rz, active)
        P, rz = step_B(pc_aux, R, R_old, P, rz, active)
        k += 1
        if rn2_prev is not None:
            vals = np.asarray(rn2_prev, np.float64)
            if not np.all(np.isfinite(vals)):
                rn2_final = rn2_prev
                break
            still = vals > threshold2
            if not np.any(still):
                rn2_final = rn2_prev
                break
            active = jnp.asarray(still)
        rn2_prev = rn2
        rn2_final = rn2
    vals = np.asarray(rn2_final, np.float64)
    relres = float(
        np.max(np.sqrt(np.maximum(vals, 0.0)) / np.where(b_norm > 0, b_norm, 1.0))
    )
    return PCGResult(X[0] + X[1], np.asarray(k), np.asarray(relres))


class NystromPreconditioner(NamedTuple):
    """Tail-damped Nyström preconditioner ``P = δ I + B Bᵀ`` with
    ``B = K_XZ L_ZZ^{-T}`` (so ``B Bᵀ`` is the rank-``m`` Nyström
    approximant) and ``δ = λ_m + σ²`` — the damping of Frangella, Tropp
    & Udell (SIMAX 2023): the unresolved tail is scaled by the smallest
    RESOLVED eigenvalue plus noise rather than ``σ²`` alone, which
    operator-transformed kernels need (their differentiation-roughened
    spectra decay too slowly for a noise-dominated tail; measured
    preconditioned condition number on the heat ``H k H*`` Gram: 5.3e5
    plain-Woodbury vs ~λ_m/σ² damped).

    Applied via the Cholesky-based Woodbury identity

        P⁻¹ r = (r − B (δI + BᵀB)⁻¹ Bᵀ r) / δ

    — direct triangular operations only.  An eigenvector-based form is
    numerically fragile in float32: ``eigh`` eigenvectors carry ~1e-3
    error, and normalizing near-null columns by ``1/sqrt(λ)``
    manufactures spurious directions that break CG outright (divergence
    at n=1e5).  Eigenvalues enter only through the scalar δ.
    """

    B: jnp.ndarray  # (n, m)
    chol_C: jnp.ndarray  # (m, m) lower Cholesky of δI + BᵀB
    delta: jnp.ndarray  # λ_m + σ²

    def _solve_core(self, br, chol_C, delta):
        """``(C0 + delta I)^{-1} br`` by one ``cho_solve``.

        Two f32 iterative-refinement sweeps here were tried against the
        hypothesis that the f32 solve error at cond ~ 1/(c*eps32) drives
        the CG iteration count, and came out neutral (55 vs 53
        iterations at N=1e5), so the plain solve is kept."""
        return jax.scipy.linalg.cho_solve((chol_C, True), br)

    def __call__(self, r: jnp.ndarray) -> jnp.ndarray:
        # Apply in the RESIDUAL's precision (mixed-precision CG passes
        # higher-precision vectors against float32 factors — same lesson
        # as ops/linalg/refine.py).  Matmul precision HIGHEST: a
        # reduced-precision float32 product (TF32, ~1e-3 rel error)
        # breaks CG outright.
        B = self.B.astype(r.dtype)
        chol_C = self.chol_C.astype(r.dtype)
        delta = self.delta.astype(r.dtype)
        hi = jax.lax.Precision.HIGHEST
        vector = r.ndim == 1
        rr = r[:, None] if vector else r
        n, m = B.shape
        chunk = 16384
        if n > chunk:
            # Chunked apply (as the chunked build below): per-chunk
            # products bound the temporaries.  Zero pad rows pass
            # through untouched.
            nc = -(-n // chunk)
            pad = nc * chunk - n
            Bp = jnp.concatenate([B, jnp.zeros((pad, m), B.dtype)]) if pad else B
            rp = (
                jnp.concatenate([rr, jnp.zeros((pad, rr.shape[1]), rr.dtype)])
                if pad
                else rr
            )
            Bc = Bp.reshape(nc, chunk, m)
            rc = rp.reshape(nc, chunk, rr.shape[1])
            br = jax.lax.scan(
                lambda acc, xs: (
                    acc + jnp.matmul(xs[0].T, xs[1], precision=hi),
                    None,
                ),
                jnp.zeros((m, rr.shape[1]), rr.dtype),
                (Bc, rc),
            )[0]
            w = self._solve_core(br, chol_C, delta)
            bw = jax.lax.map(
                lambda b: jnp.matmul(b, w, precision=hi), Bc
            ).reshape(nc * chunk, rr.shape[1])[:n]
            out = (rr - bw) / delta
        else:
            br = jnp.matmul(B.T, rr, precision=hi)
            w = self._solve_core(br, chol_C, delta)
            out = (rr - jnp.matmul(B, w, precision=hi)) / delta
        return out[:, 0] if vector else out


@partial(jax.jit, static_argnames=())
def _nystrom_factors(K_XZ: jnp.ndarray, K_ZZ: jnp.ndarray, sigma_sq):
    m = K_ZZ.shape[0]
    eps = jnp.finfo(K_ZZ.dtype).eps
    # Stabilized pivot factor: W + δI with δ relative to its scale.
    stab = eps * jnp.trace(K_ZZ) * m
    L = jnp.linalg.cholesky(K_ZZ + stab * jnp.eye(m, dtype=K_ZZ.dtype))
    hi = jax.lax.Precision.HIGHEST
    # B = K_XZ L^{-T}  =>  B Bᵀ = K_XZ W⁻¹ K_ZXᵀ  (the Nyström approximant).
    # Computed as an explicit m×m triangular inverse + one GEMM: a blocked
    # triangular_solve against an (m, n) RHS can unroll into a chain of
    # non-aliased (m, n) update-slice temporaries (26.6 GB at m=4096,
    # n=1e5), while the inverse keeps all temps m×m and the GEMM is a
    # single streaming pass.  The accuracy difference (both are
    # O(eps·cond(L))) is irrelevant for a preconditioner.
    L_inv = jax.scipy.linalg.solve_triangular(
        L, jnp.eye(m, dtype=L.dtype), lower=True
    )
    n = K_XZ.shape[0]
    chunk = 16384
    if n > chunk:
        # CHUNKED build (lax.scan): per-chunk (chunk, m) GEMMs bound
        # the temporaries of the (n, m) products.  Zero pad rows
        # contribute nothing to C0 and are sliced off B.
        nc = -(-n // chunk)
        pad = nc * chunk - n
        Kp = (
            jnp.concatenate([K_XZ, jnp.zeros((pad, m), K_XZ.dtype)])
            if pad
            else K_XZ
        )

        def step(C, blk):
            b = jnp.matmul(blk, L_inv.T, precision=hi)
            return C + jnp.matmul(b.T, b, precision=hi), b

        C0, Bc = jax.lax.scan(
            step, jnp.zeros((m, m), K_XZ.dtype), Kp.reshape(nc, chunk, m)
        )
        B = Bc.reshape(nc * chunk, m)[:n]
    else:
        B = jnp.matmul(K_XZ, L_inv.T, precision=hi)
        C0 = jnp.matmul(B.T, B, precision=hi)  # BᵀB: eigenvalues of BBᵀ
    C0 = 0.5 * (C0 + C0.T)
    # λ_m (smallest Nyström eigenvalue) — eigenVALUES only; clamp the
    # round-off tail to eps-relative of the largest.
    lam = jnp.linalg.eigvalsh(C0)
    lam_max = jnp.maximum(lam[-1], 0.0)
    lam_m = jnp.clip(lam[0], 100.0 * eps * lam_max, None)
    delta = lam_m + jnp.asarray(sigma_sq, K_ZZ.dtype)
    chol_C = jnp.linalg.cholesky(C0 + delta * jnp.eye(m, dtype=C0.dtype))
    return B, chol_C, delta


def nystrom_preconditioner(
    K_XZ: jnp.ndarray,
    K_ZZ: jnp.ndarray,
    sigma_sq,
) -> NystromPreconditioner:
    """Build the tail-damped inverse of ``Nyström(K) + σ² I``.

    ``K_XZ``: (n, m) kernel block against ``m`` landmark points;
    ``K_ZZ``: (m, m) landmark Gram; ``sigma_sq``: diagonal noise.
    """
    B, chol_C, delta = _nystrom_factors(
        jnp.asarray(K_XZ), jnp.asarray(K_ZZ), sigma_sq
    )
    return NystromPreconditioner(B, chol_C, delta)


def _host_lambda_min(C0_np, power_iters: int = 40):
    """lambda_min of a PSD matrix on the host (f64): escalating-jitter
    Cholesky + inverse power iteration.  Cheap (O(m^2) per iteration
    after one O(m^3/3) factorization) — replaces the device ``eigvalsh``
    of the legacy build, which at m >= 8192 is the expensive part."""
    import numpy as np
    import scipy.linalg

    m = C0_np.shape[0]
    scale = max(float(np.mean(np.diag(C0_np))), 1e-30)
    L = None
    for jit_rel in (0.0, 1e-14, 1e-12, 1e-10, 1e-8, 1e-6):
        try:
            L = np.linalg.cholesky(C0_np + (jit_rel * scale) * np.eye(m))
            break
        except np.linalg.LinAlgError:
            continue
    if L is None:
        return float(np.finfo(np.float32).eps * scale)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(m)
    v /= np.linalg.norm(v)
    for _ in range(power_iters):
        v = scipy.linalg.cho_solve((L, True), v)
        v /= np.linalg.norm(v)
    return float(v @ (C0_np @ v))


def _power_lambda_max(A_np, iters: int = 24):
    import numpy as np

    rng = np.random.default_rng(1)
    v = rng.standard_normal(A_np.shape[0])
    v /= np.linalg.norm(v)
    lam = 0.0
    for _ in range(iters):
        w = A_np @ v
        lam = float(np.linalg.norm(w))
        if lam == 0.0:
            return 0.0
        v = w / lam
    return lam


def nystrom_preconditioner_hybrid(
    block_fn,
    X,
    Z,
    sigma_sq,
    *,
    chunk: int = 16384,
    jitter_rel: float = 1e-10,
    f32_floor: float = 8.0,
) -> NystromPreconditioner:
    """Build the tail-damped Nyström preconditioner with the m x m math
    on the HOST in float64 and the O(n m^2) GEMMs streamed on device.

    The legacy all-device build (:func:`_nystrom_factors`) must add
    ``eps32 * trace(K_ZZ) * m`` jitter before the f32 ``K_ZZ`` Cholesky
    (a float32 factorization NaNs otherwise), and at
    m=4096 that stabilizer is ~2x the kernel DIAGONAL — a ridge that
    truncates the preconditioner's effective rank to the few hundred
    eigenvalues above ~k(0) and explains the measured 326 iterations at
    N=1e5 (the f64 spectrum predicts ~100 for an exact rank-4096
    build; experiments/precond_spectroscopy.py).  Factoring ``K_ZZ`` on
    the host in float64 needs jitter ~1e-10 relative — 8 orders less —
    and restores the spectral quality of the f64 build; the f32 rounding
    of the pushed-back ``L^{-1}`` perturbs the approximant only
    multiplicatively (~eps32), benign for a preconditioner.

    The (n, m) factor ``B`` is built by a chunked ``lax.scan`` whose
    chunks evaluate the kernel block on the fly (``block_fn``), so the
    full ``K_XZ`` never exists — the rank is bounded by the (m, m)
    factors, not by an (n, m) block.

    ``block_fn(x0, x1) -> (n0, n1)`` must be jit-traceable (e.g. a
    compensated ``terms_gram`` closure over the term specs).

    ``f32_floor`` (the constant ``c`` below) encodes the DEVICE-precision
    information limit (with host-f64-small jitter alone a float32
    rank-8192 n=32768 solve stalled at relres 5e-4):

    - the ``(n, m)`` factor ``B = K_XZ L^{-T}`` is a device GEMM whose
      f32 rounding is ~``eps * ||K_row|| * ||L^{-1}||`` per entry, so
      ``||L^{-1}||`` must stay bounded: the K_ZZ jitter gets a floor
      ``c * eps_dev * lambda_max(K_ZZ)``;
    - the Woodbury apply cancels ``r - B w`` to ``~delta/lambda_1`` of
      ``||r||`` in the deflated directions, with f32 errors
      ``~eps_dev * lambda_1``; the damping gets a floor ``delta >=
      c * eps_dev * lambda_1(C0)`` so that relative apply error is
      ``<= 1/c``.

    The induced preconditioned condition number is ``~1 + delta/sigma^2
    ~ c * eps_dev * lambda_1 / sigma^2`` — the f32 resolution limit of
    ANY rank-m Woodbury deflation, reached at moderate m (the spectrum
    below the floor is unresolvable regardless of rank).  In float64 the
    floors are ~1e-13 * lambda_1 and never bind.
    """
    import numpy as np

    X = jnp.asarray(X)
    Z = jnp.asarray(Z)
    n, m = X.shape[0], Z.shape[0]
    chunk = max(256, min(int(chunk), n))
    dtype = X.dtype if jnp.issubdtype(X.dtype, jnp.floating) else jnp.float32
    eps_dev = float(jnp.finfo(dtype).eps)

    # 1) K_ZZ on device -> host f64, robust factorization, L^{-1} back.
    K_ZZ = np.asarray(jax.jit(block_fn)(Z, Z), np.float64)
    K_ZZ = 0.5 * (K_ZZ + K_ZZ.T)
    import scipy.linalg

    scale = float(np.mean(np.diag(K_ZZ)))
    lam1_zz = _power_lambda_max(K_ZZ)
    nu_floor = f32_floor * eps_dev * lam1_zz
    L = None
    for jr in (jitter_rel, 1e-8, 1e-6, 1e-4):
        try:
            L = np.linalg.cholesky(
                K_ZZ + max(jr * scale, nu_floor) * np.eye(m)
            )
            break
        except np.linalg.LinAlgError:
            continue
    if L is None:
        raise np.linalg.LinAlgError("K_ZZ not factorizable at jitter 1e-4")
    L_inv_T = jnp.asarray(
        scipy.linalg.solve_triangular(L, np.eye(m), lower=True).T, dtype
    )

    # 2) Streamed B / C0 build (device): chunked scan, kernel blocks
    #    evaluated on the fly, pad-row contribution subtracted exactly.
    nc = -(-n // chunk)
    pad = nc * chunk - n

    @partial(jax.jit, static_argnames=())
    def build(Xp, Z, L_inv_T):
        hi = jax.lax.Precision.HIGHEST

        def step(C, x_blk):
            Kb = block_fn(x_blk, Z)
            b = jnp.matmul(Kb, L_inv_T, precision=hi)
            return C + jnp.matmul(b.T, b, precision=hi), b

        C0, Bc = jax.lax.scan(
            step,
            jnp.zeros((m, m), dtype),
            Xp.reshape((nc, chunk) + Xp.shape[1:]),
        )
        B = Bc.reshape((nc * chunk, m))
        if pad:
            Bp = B[n:]
            C0 = C0 - jnp.matmul(Bp.T, Bp, precision=hi)
            B = B[:n]
        return B, 0.5 * (C0 + C0.T)

    if pad:
        Xp = jnp.concatenate([X, jnp.broadcast_to(X[:1], (pad,) + X.shape[1:])])
    else:
        Xp = X
    B, C0 = build(Xp, Z, L_inv_T)

    # 3) m x m closing math on the host in f64.
    C0_np = np.asarray(C0, np.float64)
    C0_np = 0.5 * (C0_np + C0_np.T)
    lam_m = _host_lambda_min(C0_np)
    # Device-precision apply floor (see docstring): delta below
    # c * eps_dev * lambda_1 makes the f32 Woodbury cancellation noise
    # exceed the deflated-direction output.
    lam1_c0 = _power_lambda_max(C0_np)
    lam_m = max(lam_m, f32_floor * eps_dev * lam1_c0, 0.0)
    delta = lam_m + float(sigma_sq)
    chol_C = np.linalg.cholesky(C0_np + delta * np.eye(m))
    return NystromPreconditioner(
        B,
        jnp.asarray(chol_C, dtype),
        jnp.asarray(delta, dtype),
    )


def nystrom_preconditioner_device(
    block_fn,
    X,
    Z,
    sigma_sq,
    *,
    chunk: int = 16384,
    f32_floor: float = 8.0,
) -> NystromPreconditioner:
    """All-device floored Nyström build: SCALAR-only host traffic.

    Numerically this is :func:`nystrom_preconditioner_hybrid` — same
    streamed ``B``/``C0`` construction, same device-precision floors on
    the K_ZZ stabilizer and the damping delta — but every factorization
    runs on the DEVICE: the floors make the f32 Cholesky well-posed
    (cond ~ 1/(c * eps32), inside the f32 cliff), with the
    escalating-jitter robust Cholesky (``ops/linalg/chol.py``) as the
    safety net.  The hybrid build moves four m x m buffers through the
    host — ~1 GB at m=8192 — plus host f64 m^3 math; here only
    lambda_max/lambda_min estimates (scalars) leave the device.
    """
    from .chol import cholesky as robust_cholesky

    X = jnp.asarray(X)
    Z = jnp.asarray(Z)
    n, m = X.shape[0], Z.shape[0]
    chunk = max(256, min(int(chunk), n))
    dtype = X.dtype if jnp.issubdtype(X.dtype, jnp.floating) else jnp.float32
    eps_dev = float(jnp.finfo(dtype).eps)
    hi = jax.lax.Precision.HIGHEST

    def _lam1(A, v0):
        def body(_, v):
            w = jnp.matmul(A, v, precision=hi)
            return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

        v = jax.lax.fori_loop(0, 16, body, v0)
        return jnp.linalg.norm(jnp.matmul(A, v, precision=hi))

    @jax.jit
    def kzz_and_lam1(Z):
        K_ZZ = block_fn(Z, Z)
        K_ZZ = 0.5 * (K_ZZ + K_ZZ.T)
        v0 = jnp.ones((m,), K_ZZ.dtype) / jnp.sqrt(jnp.asarray(m, K_ZZ.dtype))
        return K_ZZ, _lam1(K_ZZ, v0)

    K_ZZ, lam1_zz = kzz_and_lam1(Z)
    nu = f32_floor * eps_dev * float(lam1_zz)
    L = robust_cholesky(
        K_ZZ + nu * jnp.eye(m, dtype=K_ZZ.dtype), jitter=0.0
    )

    nc = -(-n // chunk)
    pad = nc * chunk - n

    @jax.jit
    def build(Xp, Z, L):
        L_inv_T = jax.scipy.linalg.solve_triangular(
            L, jnp.eye(m, dtype=L.dtype), lower=True
        ).T

        def step(C, x_blk):
            Kb = block_fn(x_blk, Z)
            b = jnp.matmul(Kb, L_inv_T, precision=hi)
            return C + jnp.matmul(b.T, b, precision=hi), b

        C0, Bc = jax.lax.scan(
            step,
            jnp.zeros((m, m), dtype),
            Xp.reshape((nc, chunk) + Xp.shape[1:]),
        )
        B = Bc.reshape((nc * chunk, m))
        if pad:
            Bp = B[n:]
            C0 = C0 - jnp.matmul(Bp.T, Bp, precision=hi)
            B = B[:n]
        C0 = 0.5 * (C0 + C0.T)
        v0 = jnp.ones((m,), C0.dtype) / jnp.sqrt(jnp.asarray(m, C0.dtype))
        return B, C0, _lam1(C0, v0)

    if pad:
        Xp = jnp.concatenate([X, jnp.broadcast_to(X[:1], (pad,) + X.shape[1:])])
    else:
        Xp = X
    B, C0, lam1_c0 = build(Xp, Z, L)
    lam1_c0 = float(lam1_c0)

    # lambda_min(C0) by on-device inverse iteration against a minimally
    # stabilized factor (the Frangella-Tropp tail damping needs it when
    # it exceeds the f32 floor, e.g. in float64 or at small scales).
    chol0 = robust_cholesky(C0, jitter=eps_dev)

    @jax.jit
    def lam_min_est(C0, chol0):
        v0 = jnp.ones((m,), C0.dtype) / jnp.sqrt(jnp.asarray(m, C0.dtype))

        def body(_, v):
            w = jax.scipy.linalg.cho_solve((chol0, True), v)
            return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

        v = jax.lax.fori_loop(0, 24, body, v0)
        return jnp.vdot(v, jnp.matmul(C0, v, precision=hi))

    lam_m = max(float(lam_min_est(C0, chol0)), 0.0)
    delta = max(lam_m, f32_floor * eps_dev * lam1_c0) + float(sigma_sq)
    chol_C = robust_cholesky(
        C0 + delta * jnp.eye(m, dtype=C0.dtype), jitter=0.0
    )
    return NystromPreconditioner(B, chol_C, jnp.asarray(delta, dtype))


def landmark_indices(n: int, m: int) -> jnp.ndarray:
    """``m`` deterministic, evenly spread landmark indices in ``[0, n)``.

    Evenly strided points are the right default for the quasi-uniform
    collocation grids of PDE problems (no RNG ⇒ reproducible posteriors).
    """
    m = int(min(m, n))
    return jnp.asarray(
        (jnp.arange(m, dtype=jnp.float64 if jax.config.jax_enable_x64 else jnp.float32) + 0.5)
        * (n / m),
        dtype=jnp.int32,
    )
